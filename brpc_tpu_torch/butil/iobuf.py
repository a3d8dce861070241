"""IOBuf — a chain of blocks viewed through (block, offset, length) refs.

Port of the parts of brpc_tpu/butil/iobuf.py that the tensor lane uses.
Blocks are host bytes, or DEVICE blocks that hold a ``torch.Tensor``
(the counterpart of ``Block.device_block``): a tensor rides the chain
untouched and is copied to the host once, when a wire boundary reads its
bytes. A socket reads into one (``append_from_socket``) and writes from
one (``cut_into_socket``) without blocking, through TLS as well (an
``ssl.SSLSocket``: a view at a time, and the TLS layer's want-read and
want-write are would-block). Left out: the thread-local block cache,
user blocks with deleters and the read-arena seam.
"""
from __future__ import annotations

import errno
import ssl
from collections import deque
from itertools import islice
from typing import Iterable, Union

import torch


TLS_READ = 32768  # a TLS record holds at most 16 KiB of data


class Block:
    """A contiguous chunk: host bytes, or a tensor (``kind == DEVICE``)."""

    __slots__ = ("data", "size", "kind", "device_array")

    HOST = 0
    DEVICE = 2

    def __init__(self, data: bytes):
        self.data = data
        self.size = len(data)
        self.kind = Block.HOST
        self.device_array = None

    @classmethod
    def device_block(cls, tensor) -> "Block":
        """Wrap a tensor (on the card or the host). Zero-copy until a wire
        boundary reads its bytes."""
        b = cls.__new__(cls)
        b.data = None
        b.size = tensor.numel() * tensor.element_size()
        b.kind = Block.DEVICE
        b.device_array = tensor
        return b

    def materialize(self):
        """Host view of the block's bytes. A DEVICE block costs one
        device-to-host copy (none for a contiguous host tensor), cached."""
        if self.data is None:
            t = self.device_array.detach().contiguous().cpu()
            self.data = memoryview(t.reshape(-1).view(torch.uint8).numpy())
        return self.data


class BlockRef:
    """View of [offset, offset+length) inside one Block."""

    __slots__ = ("block", "offset", "length")

    def __init__(self, block: Block, offset: int, length: int):
        self.block = block
        self.offset = offset
        self.length = length

    def view(self) -> memoryview:
        data = self.block.materialize()
        return memoryview(data)[self.offset: self.offset + self.length]


class IOBuf:
    """Chain of BlockRefs. Structural ops move refs, not bytes."""

    __slots__ = ("_refs", "_length")

    def __init__(self, data=None):
        self._refs: "deque[BlockRef]" = deque()
        self._length = 0
        if data is not None:
            self.append(data)

    def __len__(self) -> int:
        return self._length

    def empty(self) -> bool:
        return self._length == 0

    def append(self, data: Union[bytes, bytearray, memoryview, str, "IOBuf"]):
        """Append bytes (a ``bytes`` object is kept as is, other buffers
        are copied once) or share another IOBuf's blocks."""
        if isinstance(data, IOBuf):
            self._refs.extend(
                BlockRef(r.block, r.offset, r.length) for r in data._refs)
            self._length += data._length
            return
        if isinstance(data, str):
            data = data.encode()
        elif not isinstance(data, bytes):
            data = bytes(data)
        if data:
            b = Block(data)
            self._append_ref(BlockRef(b, 0, b.size))

    def append_device_array(self, tensor):
        """Zero-copy append of a tensor."""
        b = Block.device_block(tensor)
        self._append_ref(BlockRef(b, 0, b.size))

    def _append_ref(self, ref: BlockRef):
        if ref.length:
            self._refs.append(ref)
            self._length += ref.length

    def cut(self, n: int) -> "IOBuf":
        """Move the first n bytes into a new IOBuf without copying."""
        out = IOBuf()
        remain = min(n, self._length)
        while remain > 0:
            r = self._refs[0]
            if r.length <= remain:
                out._append_ref(self._refs.popleft())
                self._length -= r.length
                remain -= r.length
            else:
                out._append_ref(BlockRef(r.block, r.offset, remain))
                r.offset += remain
                r.length -= remain
                self._length -= remain
                remain = 0
        return out

    def cutn_bytes(self, n: int) -> bytearray:
        """Copy out and remove the first n bytes. A bytearray, so a tensor
        can be laid over it (``torch.frombuffer``) without another copy."""
        return self.cut(n).copy_to_bytes()

    def pop_front(self, n: int) -> int:
        n = min(n, self._length)
        self.cut(n)
        return n

    def copy_to_bytes(self, n: int = None, pos: int = 0) -> bytearray:
        """Copy n bytes starting at pos (default: to the end), leaving the
        chain as it is."""
        if n is None:
            n = self._length - pos
        n = max(0, min(n, self._length - pos))
        out = bytearray(n)
        wrote, skip = 0, pos
        for r in self._refs:
            if wrote >= n:
                break
            if skip >= r.length:
                skip -= r.length
                continue
            take = min(r.length - skip, n - wrote)
            out[wrote: wrote + take] = r.view()[skip: skip + take]
            wrote += take
            skip = 0
        return out

    def to_bytes(self) -> bytes:
        return bytes(self.copy_to_bytes())

    def append_from_socket(self, fd, max_bytes: int) -> int:
        """Append at most max_bytes read from ``fd``; 0 at EOF. A socket
        with nothing to read raises BlockingIOError. A plain socket takes
        one ``recv``; a TLS socket is read record by record until
        max_bytes or until the TLS layer wants more from the peer, so no
        decrypted byte is left inside it without a readable edge to
        come."""
        if isinstance(fd, ssl.SSLSocket):
            return self._append_from_tls(fd, max_bytes)
        data = fd.recv(max_bytes)
        if data:
            self._append_ref(BlockRef(Block(data), 0, len(data)))
        return len(data)

    def _append_from_tls(self, fd, max_bytes: int) -> int:
        got = 0
        while got < max_bytes:
            try:
                data = fd.recv(min(TLS_READ, max_bytes - got))
            except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                if got == 0:
                    raise BlockingIOError(errno.EAGAIN, "tls wants more")
                break
            if not data:
                break  # EOF: the bytes read so far first
            self._append_ref(BlockRef(Block(data), 0, len(data)))
            got += len(data)
        return got

    def cut_into_socket(self, fd, max_views: int = 64) -> int:
        """Send from the front and drop what was sent; returns the bytes
        sent. A full socket raises BlockingIOError. A plain socket takes
        one ``sendmsg`` of up to max_views blocks; a TLS socket, which
        cannot gather, the front block alone (the same bytes again when
        the TLS layer asked to be called back)."""
        if isinstance(fd, ssl.SSLSocket):
            if not self._refs:
                return 0
            try:
                n = fd.send(self._refs[0].view())
            except (ssl.SSLWantWriteError, ssl.SSLWantReadError):
                raise BlockingIOError(errno.EAGAIN, "tls wants the socket")
        else:
            views = [r.view() for r in islice(self._refs, max_views)]
            n = fd.sendmsg(views) if views else 0
        self.pop_front(n)
        return n

    def iter_views(self) -> Iterable[memoryview]:
        for r in self._refs:
            yield r.view()
