"""IOBuf — a chain of blocks viewed through (block, offset, length) refs.

Port of brpc_tpu/butil/iobuf.py. Blocks are host bytes, user memory
(``append_user_data``: zero-copy, with a deleter and a 64-bit meta that
travel with the block), or DEVICE blocks that hold a ``torch.Tensor``
(the counterpart of ``Block.device_block``): a tensor rides the chain
untouched (``device_arrays`` returns it as the same storage) and is
copied to the host once, when a wire boundary or
``cut_into_file_descriptor`` reads its bytes. A per-thread block cache
(``share_tls_block``) gives writers and fd readers the free tail of
one block after another. ``IOPortal`` is the IOBuf a socket reads into:
``append_from_socket`` without blocking, through TLS as well (an
``ssl.SSLSocket``: a record at a time, the TLS layer's want-read and
want-write are would-block), and ``append_from_file_descriptor``;
``cut_into_socket`` writes from the front. ``IOBufAppender`` and
``IOBufCutter`` are the sequential writer and front parser.

``set_block_allocator`` is the blockmem_allocate seam: with a factory
installed, appended bytes and plain-socket reads are staged into the
blocks it gives (the device transport points it at a shared, page-locked
HostArena: ``HostArena.install_as_iobuf_allocator``,
``install_read_arena``); without one, an appended ``bytes`` object is
kept as it is and a socket read becomes a block of its own.
"""
from __future__ import annotations

import errno
import os
import ssl
import threading
from collections import deque
from itertools import islice
from typing import Callable, Iterable, List, Optional, Union

import torch


TLS_READ = 32768  # a TLS record holds at most 16 KiB of data
DEFAULT_BLOCK_SIZE = 8192  # a cached block's payload
IOV_MAX = 64  # views in one gathered write

_tls = threading.local()


class Block:
    """A contiguous chunk: host bytes, user memory (``kind == USER``) or a
    tensor (``kind == DEVICE``). A block made by ``writable`` is filled
    from its front; refs view only what was filled."""

    __slots__ = ("data", "size", "capacity", "kind", "deleter", "meta",
                 "device_array", "__weakref__")

    HOST = 0
    USER = 1  # caller-owned memory, handed to ``deleter`` on release
    DEVICE = 2

    def __init__(self, data: bytes):
        self.data = data
        self.size = len(data)
        self.capacity = self.size
        self.kind = Block.HOST
        self.deleter: Optional[Callable] = None
        self.meta = 0
        self.device_array = None

    @classmethod
    def writable(cls, capacity: int = DEFAULT_BLOCK_SIZE) -> "Block":
        """An empty host block of ``capacity`` bytes."""
        b = cls(bytearray(capacity))
        b.size = 0
        b.capacity = capacity
        return b

    @classmethod
    def user_block(cls, mem, deleter: Optional[Callable] = None,
                   meta: int = 0) -> "Block":
        b = cls(mem)
        b.kind = Block.USER
        b.deleter = deleter
        b.meta = meta
        return b

    @classmethod
    def device_block(cls, tensor) -> "Block":
        """Wrap a tensor (on the card or the host). Zero-copy until a wire
        boundary reads its bytes."""
        b = cls(b"")
        b.data = None
        b.size = b.capacity = tensor.numel() * tensor.element_size()
        b.kind = Block.DEVICE
        b.device_array = tensor
        return b

    def left_space(self) -> int:
        return self.capacity - self.size

    def release(self):
        """Hand user memory to its deleter, once."""
        if self.deleter is not None:
            self.deleter(self.data)
            self.deleter = None

    def materialize(self):
        """Host view of the block's bytes. A DEVICE block costs one
        device-to-host copy (none for a contiguous host tensor), cached."""
        if self.data is None:
            t = self.device_array.detach().contiguous().cpu()
            self.data = memoryview(t.reshape(-1).view(torch.uint8).numpy())
        return self.data


def _tls_block_cache() -> List[Block]:
    cache = getattr(_tls, "blocks", None)
    if cache is None:
        cache = _tls.blocks = []
    return cache


# The blockmem_allocate seam (iobuf.cpp:163-168): a factory of fresh
# writable blocks, or None. It returns None to fall back to a plain host
# block (its memory exhausted).
_block_allocator: Optional[Callable[[], Optional[Block]]] = None
_alloc_gen = 0  # bumped at every switch; stamps each thread's cache


def set_block_allocator(alloc: Optional[Callable[[], Optional[Block]]]):
    """Install (or, with None, remove) the block factory. Every thread's
    cached blocks from before the switch are dropped at its next use."""
    global _block_allocator, _alloc_gen
    _block_allocator = alloc
    _alloc_gen += 1


def _new_block() -> Block:
    alloc = _block_allocator
    if alloc is not None:
        b = alloc()
        if b is not None:
            return b
    return Block.writable()


def share_tls_block() -> Block:
    """This thread's cached block with free space, a new one when the
    last is full."""
    if getattr(_tls, "alloc_gen", None) != _alloc_gen:
        _tls.blocks = []
        _tls.alloc_gen = _alloc_gen
    cache = _tls_block_cache()
    while cache:
        b = cache[-1]
        if b.left_space() > 0:
            return b
        cache.pop()
    b = _new_block()
    cache.append(b)
    return b


def release_tls_blocks():
    _tls_block_cache().clear()


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
        if _block_allocator is not None:
            self._append_staged(memoryview(data).cast("B"))
            return
        if not isinstance(data, bytes):
            data = bytes(data)
        if data:
            b = Block(data)
            self._append_ref(BlockRef(b, 0, b.size))

    def _append_staged(self, mv: memoryview):
        """Copy into this thread's cached blocks (the allocator's)."""
        pos, n = 0, len(mv)
        while pos < n:
            b = share_tls_block()
            take = min(n - pos, b.left_space())
            b.data[b.size: b.size + take] = mv[pos: pos + take]
            self._append_ref(BlockRef(b, b.size, take))
            b.size += take
            pos += take

    def append_user_data(self, mem, deleter: Optional[Callable] = None,
                         meta: int = 0):
        """Zero-copy append of caller-owned memory; ``meta`` travels with
        the block and ``deleter(mem)`` runs when it is released."""
        b = Block.user_block(mem, deleter, meta)
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

    def cut_into_socket(self, fd, max_views: int = IOV_MAX) -> int:
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

    def device_arrays(self) -> List:
        """The tensors riding the chain's DEVICE blocks, in order (the
        same storage, not copies)."""
        return [r.block.device_array for r in self._refs
                if r.block.kind == Block.DEVICE]

    def cut_into_file_descriptor(self, fd: int,
                                 max_bytes: Optional[int] = None) -> int:
        """One gathered write of the front of the chain (a DEVICE block's
        tensor is read to the host first); drops and returns what was
        written."""
        limit = (self._length if max_bytes is None
                 else min(max_bytes, self._length))
        views, got = [], 0
        for r in islice(self._refs, IOV_MAX):
            if got >= limit:
                break
            take = min(r.length, limit - got)
            v = r.view()
            views.append(v[:take] if take < r.length else v)
            got += take
        if not views:
            return 0
        n = os.writev(fd, views)
        if n > 0:
            self.pop_front(n)
        return n

    def iter_views(self) -> Iterable[memoryview]:
        for r in self._refs:
            yield r.view()


class IOPortal(IOBuf):
    """The IOBuf a connection reads into."""

    __slots__ = ()

    def append_from_socket(self, fd, max_bytes: int = 65536) -> int:
        """Append at most max_bytes read from ``fd``; 0 at EOF. A socket
        with nothing to read raises BlockingIOError. A plain socket takes
        one ``recv``; a TLS socket is read record by record until
        max_bytes or until the TLS layer wants more from the peer, so no
        decrypted byte is left inside it without a readable edge to
        come."""
        if isinstance(fd, ssl.SSLSocket):
            return self._append_from_tls(fd, max_bytes)
        if _block_allocator is not None:
            return self._recv_staged(fd, max_bytes)
        data = fd.recv(max_bytes)
        if data:
            self._append_ref(BlockRef(Block(data), 0, len(data)))
        return len(data)

    def _recv_staged(self, fd, max_bytes: int) -> int:
        """Read straight into this thread's cached blocks (the
        allocator's), block after block."""
        got = 0
        while got < max_bytes:
            b = share_tls_block()
            want = min(b.left_space(), max_bytes - got)
            try:
                n = fd.recv_into(
                    memoryview(b.data)[b.size: b.size + want], want)
            except BlockingIOError:
                if got == 0:
                    raise
                break
            if not n:
                break  # EOF: the bytes read so far first
            self._append_ref(BlockRef(b, b.size, n))
            b.size += n
            got += n
            if n < want:
                break
        return got

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

    def append_from_file_descriptor(self, fd: int,
                                    max_bytes: int = 65536) -> int:
        """Read at most max_bytes from ``fd`` into this thread's cached
        blocks; 0 at EOF, BlockingIOError when nothing is there yet."""
        got = 0
        while got < max_bytes:
            b = share_tls_block()
            want = min(b.left_space(), max_bytes - got)
            try:
                data = os.read(fd, want)
            except BlockingIOError:
                if got == 0:
                    raise
                break
            if not data:
                break  # EOF: the bytes read so far first
            n = len(data)
            b.data[b.size: b.size + n] = data
            self._append_ref(BlockRef(b, b.size, n))
            b.size += n
            got += n
            if n < want:
                break
        return got


class IOBufAppender:
    """A sequential writer into an IOBuf."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = IOBuf()

    def append(self, data):
        self.buf.append(data)

    def push_back(self, byte: int):
        self.buf.append(bytes([byte]))

    def take(self) -> IOBuf:
        """What was written; the appender starts a new IOBuf."""
        out, self.buf = self.buf, IOBuf()
        return out


class IOBufCutter:
    """A sequential parser of an IOBuf's front."""

    __slots__ = ("_buf",)

    def __init__(self, buf: IOBuf):
        self._buf = buf

    def remaining(self) -> int:
        return len(self._buf)

    def peek_bytes(self, n: int) -> bytes:
        return bytes(self._buf.copy_to_bytes(n))

    def cutn(self, n: int) -> bytes:
        if len(self._buf) < n:
            raise EOFError(f"need {n} bytes, have {len(self._buf)}")
        return bytes(self._buf.cutn_bytes(n))

    def cut_uint32_be(self) -> int:
        return int.from_bytes(self.cutn(4), "big")

    def cut_uint64_be(self) -> int:
        return int.from_bytes(self.cutn(8), "big")
