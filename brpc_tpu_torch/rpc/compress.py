"""Compression of tpu_std payloads.

Port of brpc_tpu/rpc/compress.py: a registry of (compress, decompress)
pairs by ``compress_type`` code, with gzip (``compressobj(6, DEFLATED,
31)``), zlib at level 6 and a snappy block codec in pure Python, so both
packages give the same bytes for the same input. A frame compresses its
payload only, never its attachment: tensors go as they are.

``compress`` and ``decompress`` pass empty data and type 0 through, and
raise ValueError for a type nobody registered, as the reference does. A
payload that does not decode raises ValueError with the codec's text,
which the server answers as EREQUEST "fail to parse request".
"""
from __future__ import annotations

import struct
import zlib
from typing import Callable, Dict, Tuple

# the compress_type codes of RpcMeta
COMPRESS_NONE = 0
COMPRESS_GZIP = 1
COMPRESS_ZLIB = 2
COMPRESS_SNAPPY = 3

_handlers: Dict[int, Tuple[Callable[[bytes], bytes],
                           Callable[[bytes], bytes]]] = {}


def register_compress(ctype: int, compress_fn, decompress_fn):
    _handlers[ctype] = (compress_fn, decompress_fn)


def _pair(ctype: int):
    pair = _handlers.get(ctype)
    if pair is None:
        raise ValueError(f"unknown compress type {ctype}")
    return pair


def compress(data: bytes, ctype: int) -> bytes:
    if ctype == COMPRESS_NONE or not data:
        return data
    return _pair(ctype)[0](data)


def decompress(data: bytes, ctype: int) -> bytes:
    if ctype == COMPRESS_NONE or not data:
        return data
    fn = _pair(ctype)[1]
    try:
        return fn(data)
    except (zlib.error, IndexError, struct.error) as e:
        raise ValueError(str(e)) from e


def _gzip_compress(d: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 31)  # 31: the gzip wrapper
    return co.compress(d) + co.flush()


register_compress(COMPRESS_GZIP, _gzip_compress,
                  lambda d: zlib.decompress(d, wbits=31))
register_compress(COMPRESS_ZLIB, lambda d: zlib.compress(d, 6),
                  zlib.decompress)


# -- snappy block format ----------------------------------------------------
# google/snappy's format: a varint32 uncompressed length, then literal
# elements (tag 00) and copy elements (tags 01/10/11). The encoder emits
# literals and 2-byte-offset copies of at most 64 bytes, found through a
# table of 4-byte keys, exactly as the reference's does.

def _varint_encode(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varint_decode(data: bytes, pos: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 35:
            raise ValueError("snappy: varint too long")


def _emit_literal(out: bytearray, data, start: int, end: int):
    length = end - start
    while length > 0:
        run = min(length, 1 << 32)
        n = run - 1
        if n < 60:
            out.append(n << 2)
        elif n < (1 << 8):
            out.append(60 << 2)
            out.append(n)
        elif n < (1 << 16):
            out.append(61 << 2)
            out += struct.pack("<H", n)
        elif n < (1 << 24):
            out.append(62 << 2)
            out += struct.pack("<I", n)[:3]
        else:
            out.append(63 << 2)
            out += struct.pack("<I", n)
        out += data[start:start + run]
        start += run
        length -= run


def snappy_compress(data: bytes) -> bytes:
    data = bytes(data)
    n = len(data)
    out = bytearray(_varint_encode(n))
    if n < 4:
        if n:
            _emit_literal(out, data, 0, n)
        return bytes(out)
    table: Dict[bytes, int] = {}
    pos = lit_start = 0
    limit = n - 4
    while pos <= limit:
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is None or pos - cand > 0xFFFF:
            pos += 1
            continue
        mlen = 4
        while (pos + mlen < n and mlen < 64
               and data[cand + mlen] == data[pos + mlen]):
            mlen += 1
        if lit_start < pos:
            _emit_literal(out, data, lit_start, pos)
        out.append(((mlen - 1) << 2) | 2)  # tag 10: a 2-byte offset copy
        out += struct.pack("<H", pos - cand)
        pos += mlen
        lit_start = pos
    if lit_start < n:
        _emit_literal(out, data, lit_start, n)
    return bytes(out)


def snappy_decompress(data: bytes) -> bytes:
    total, pos = _varint_decode(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        elem = tag & 3
        if elem == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                length = int.from_bytes(data[pos:pos + nbytes], "little") + 1
                pos += nbytes
            out += data[pos:pos + length]
            pos += length
            continue
        if elem == 1:  # 1-byte offset, length 4-11
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif elem == 2:  # 2-byte little-endian offset
            length = (tag >> 2) + 1
            offset = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        else:  # 4-byte little-endian offset
            length = (tag >> 2) + 1
            offset = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: bad copy offset")
        start = len(out) - offset
        if offset >= length:  # disjoint: one slice
            out += out[start:start + length]
        else:  # overlapping: byte by byte, a run
            for i in range(length):
                out.append(out[start + i])
    if len(out) != total:
        raise ValueError(f"snappy: declared {total} bytes, decoded {len(out)}")
    return bytes(out)


register_compress(COMPRESS_SNAPPY, snappy_compress, snappy_decompress)
