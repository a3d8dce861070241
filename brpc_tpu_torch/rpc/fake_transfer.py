"""Cross-process fake of the transfer fabric — the xfer lane's test
transport, a twin of brpc_tpu/rpc/fake_transfer.py.

The same server surface as the CUDA IPC backend, over plain TCP:
``await_pull`` parks published tensors, a peer's ``connect(addr)`` /
``pull(uid, specs, device)`` dials back and streams the bytes, and
serving a pull releases the publication. Its bytes are the reference's,
so a reference peer and a port peer pull from each other:

    request   uid u64
    reply     count u32, then for each tensor: nbytes u64 | raw bytes

Enable with BRPC_TPU_FAKE_XFER=1 (read by
device_transport._global_xfer_server), as in the reference.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import List, Sequence

import torch

from brpc_tpu_torch.device import DeviceLike
from brpc_tpu_torch.rpc.cuda_ipc_transfer import recv_exact


def _lane_error(what: str) -> ValueError:
    return ValueError(f"xfer lane (fake transfer): {what}")


def _recv_exact(conn: socket.socket, n: int, what: str) -> bytearray:
    return recv_exact(conn, n, what, _lane_error)


class FakeTransferConnection:
    def __init__(self, addr: str):
        self.addr = addr

    def pull(self, uid: int, specs, device: DeviceLike = None) -> List[torch.Tensor]:
        """Dial the publisher and stream each tensor's bytes; ``specs`` are
        (dtype, shape, nbytes). The bytes land on ``device`` with a plain
        copy, as the reference's fake lands them with ``jax.device_put``
        (neither takes a block of the pool)."""
        from brpc_tpu_torch.device import resolve_device
        from brpc_tpu_torch.rpc.device_transport import _bytes_as

        host, _, port = self.addr.rpartition(":")
        with socket.create_connection((host, int(port)), timeout=15) as c:
            c.sendall(struct.pack(">Q", uid))
            (count,) = struct.unpack(">I", _recv_exact(c, 4, "count"))
            if count != len(specs):
                raise _lane_error(f"{count} tensors published, "
                                  f"{len(specs)} requested")
            target = resolve_device(device)
            out = []
            for i, (dtype, shape, want) in enumerate(specs):
                (nbytes,) = struct.unpack(">Q", _recv_exact(c, 8, f"size {i}"))
                if nbytes != want:
                    raise _lane_error(f"tensor {i}: {nbytes} bytes "
                                      f"published, {want} announced")
                raw = _recv_exact(c, nbytes, f"tensor {i}")
                u8 = (torch.frombuffer(raw, dtype=torch.uint8) if nbytes
                      else torch.empty(0, dtype=torch.uint8))
                out.append(_bytes_as(u8, dtype, shape).to(target, copy=True))
            return out


def _raw(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


class FakeTransferServer:
    """Quacks like the transfer server: address(), await_pull(uid,
    tensors), connect(addr)."""

    same_host_only = False  # TCP reaches any host, as the real fabric does

    def __init__(self, ip: str = "127.0.0.1"):
        self._published = {}
        self._cv = threading.Condition()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((ip, 0))
        self._listener.listen(16)
        self._port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="fake_xfer_server").start()

    # wildcard on purpose: exercises the peer-facing address resolution
    # (resolve_xfer_addr substitutes the handshake connection's IP)
    def address(self) -> str:
        return f"0.0.0.0:{self._port}"

    def await_pull(self, uid: int, tensors: Sequence):
        with self._cv:
            self._published[uid] = list(tensors)
            self._cv.notify_all()

    def cancel(self, uid: int):
        with self._cv:
            self._published.pop(uid, None)

    def connect(self, addr: str) -> FakeTransferConnection:
        return FakeTransferConnection(addr)

    def published_count(self) -> int:
        with self._cv:
            return len(self._published)

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        with conn:
            try:
                head = _recv_exact(conn, 8, "uid")
            except ValueError:
                return
            (uid,) = struct.unpack(">Q", head)
            with self._cv:
                self._cv.wait_for(lambda: uid in self._published, 10.0)
                # serving the pull RELEASES the publication
                tensors = self._published.pop(uid, None)
            try:
                if tensors is None:
                    conn.sendall(struct.pack(">I", 0))
                    return
                conn.sendall(struct.pack(">I", len(tensors)))
                for t in tensors:
                    raw = _raw(t)
                    conn.sendall(struct.pack(">Q", len(raw)) + raw)
            except OSError:
                pass

    def stop(self):
        try:
            self._listener.close()
        except OSError:
            pass
