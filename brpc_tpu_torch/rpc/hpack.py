"""HPACK (RFC 7541): header compression for h2.

Port of brpc_tpu/rpc/hpack.py, byte for byte: the full decoder (static
table, dynamic table with its size updates, Huffman), and the encoder
the reference uses, static-table indexing plus literals without
indexing, so the peer's dynamic table is never touched. A header block
the port encodes is the reference's, byte for byte.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# RFC 7541 Appendix A — static table
STATIC_TABLE: List[Tuple[str, str]] = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
    ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""), ("content-location", ""),
    ("content-range", ""), ("content-type", ""), ("cookie", ""), ("date", ""),
    ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
]
_STATIC_LOOKUP = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _STATIC_LOOKUP.setdefault((_n, _v), _i + 1)
    _STATIC_LOOKUP.setdefault((_n, None), _i + 1)

# RFC 7541 Appendix B — Huffman code table (code, bit-length) per byte 0-255
# + EOS. Stored compactly; decoder built as a binary trie.
_HUFFMAN_CODES = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12), (0x1ff9, 13),
    (0x15, 6), (0xf8, 8), (0x7fa, 11), (0x3fa, 10), (0x3fb, 10), (0xf9, 8),
    (0x7fb, 11), (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6), (0x0, 5),
    (0x1, 5), (0x2, 5), (0x19, 6), (0x1a, 6), (0x1b, 6), (0x1c, 6),
    (0x1d, 6), (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8), (0x7ffc, 15),
    (0x20, 6), (0xffb, 12), (0x3fc, 10), (0x1ffa, 13), (0x21, 6), (0x5d, 7),
    (0x5e, 7), (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7), (0x63, 7),
    (0x64, 7), (0x65, 7), (0x66, 7), (0x67, 7), (0x68, 7), (0x69, 7),
    (0x6a, 7), (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7), (0x6f, 7),
    (0x70, 7), (0x71, 7), (0x72, 7), (0xfc, 8), (0x73, 7), (0xfd, 8),
    (0x1ffb, 13), (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5), (0x24, 6), (0x5, 5),
    (0x25, 6), (0x26, 6), (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5), (0x2b, 6), (0x76, 7),
    (0x2c, 6), (0x8, 5), (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15), (0x7fc, 11), (0x3ffd, 14),
    (0x1ffd, 13), (0xffffffc, 28), (0xfffe6, 20), (0x3fffd2, 22),
    (0xfffe7, 20), (0xfffe8, 20), (0x3fffd3, 22), (0x3fffd4, 22),
    (0x3fffd5, 22), (0x7fffd9, 23), (0x3fffd6, 22), (0x7fffda, 23),
    (0x7fffdb, 23), (0x7fffdc, 23), (0x7fffdd, 23), (0x7fffde, 23),
    (0xffffeb, 24), (0x7fffdf, 23), (0xffffec, 24), (0xffffed, 24),
    (0x3fffd7, 22), (0x7fffe0, 23), (0xffffee, 24), (0x7fffe1, 23),
    (0x7fffe2, 23), (0x7fffe3, 23), (0x7fffe4, 23), (0x1fffdc, 21),
    (0x3fffd8, 22), (0x7fffe5, 23), (0x3fffd9, 22), (0x7fffe6, 23),
    (0x7fffe7, 23), (0xffffef, 24), (0x3fffda, 22), (0x1fffdd, 21),
    (0xfffe9, 20), (0x3fffdb, 22), (0x3fffdc, 22), (0x7fffe8, 23),
    (0x7fffe9, 23), (0x1fffde, 21), (0x7fffea, 23), (0x3fffdd, 22),
    (0x3fffde, 22), (0xfffff0, 24), (0x1fffdf, 21), (0x3fffdf, 22),
    (0x7fffeb, 23), (0x7fffec, 23), (0x1fffe0, 21), (0x1fffe1, 21),
    (0x3fffe0, 22), (0x1fffe2, 21), (0x7fffed, 23), (0x3fffe1, 22),
    (0x7fffee, 23), (0x7fffef, 23), (0xfffea, 20), (0x3fffe2, 22),
    (0x3fffe3, 22), (0x3fffe4, 22), (0x7ffff0, 23), (0x3fffe5, 22),
    (0x3fffe6, 22), (0x7ffff1, 23), (0x3ffffe0, 26), (0x3ffffe1, 26),
    (0xfffeb, 20), (0x7fff1, 19), (0x3fffe7, 22), (0x7ffff2, 23),
    (0x3fffe8, 22), (0x1ffffec, 25), (0x3ffffe2, 26), (0x3ffffe3, 26),
    (0x3ffffe4, 26), (0x7ffffde, 27), (0x7ffffdf, 27), (0x3ffffe5, 26),
    (0xfffff1, 24), (0x1ffffed, 25), (0x7fff2, 19), (0x1fffe3, 21),
    (0x3ffffe6, 26), (0x7ffffe0, 27), (0x7ffffe1, 27), (0x3ffffe7, 26),
    (0x7ffffe2, 27), (0xfffff2, 24), (0x1fffe4, 21), (0x1fffe5, 21),
    (0x3ffffe8, 26), (0x3ffffe9, 26), (0xffffffd, 28), (0x7ffffe3, 27),
    (0x7ffffe4, 27), (0x7ffffe5, 27), (0xfffec, 20), (0xfffff3, 24),
    (0xfffed, 20), (0x1fffe6, 21), (0x3fffe9, 22), (0x1fffe7, 21),
    (0x1fffe8, 21), (0x7ffff3, 23), (0x3fffea, 22), (0x3fffeb, 22),
    (0x1ffffee, 25), (0x1ffffef, 25), (0xfffff4, 24), (0xfffff5, 24),
    (0x3ffffea, 26), (0x7ffff4, 23), (0x3ffffeb, 26), (0x7ffffe6, 27),
    (0x3ffffec, 26), (0x3ffffed, 26), (0x7ffffe7, 27), (0x7ffffe8, 27),
    (0x7ffffe9, 27), (0x7ffffea, 27), (0x7ffffeb, 27), (0xffffffe, 28),
    (0x7ffffec, 27), (0x7ffffed, 27), (0x7ffffee, 27), (0x7ffffef, 27),
    (0x7fffff0, 27), (0x3ffffee, 26),
]
_EOS = (0x3fffffff, 30)

# decoder trie: dict-of-dicts is slow; use (node -> [left, right, symbol])
_trie = [[None, None, None]]


def _trie_insert(code: int, nbits: int, symbol: int):
    node = 0
    for i in range(nbits - 1, -1, -1):
        bit = (code >> i) & 1
        nxt = _trie[node][bit]
        if nxt is None:
            _trie.append([None, None, None])
            nxt = len(_trie) - 1
            _trie[node][bit] = nxt
        node = nxt
    _trie[node][2] = symbol


for _sym, (_code, _nbits) in enumerate(_HUFFMAN_CODES):
    _trie_insert(_code, _nbits, _sym)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = 0
    padding = 0
    pad_all_ones = True
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            node = _trie[node][bit]
            if node is None:
                raise ValueError("bad huffman sequence")
            sym = _trie[node][2]
            if sym is not None:
                out.append(sym)
                node = 0
                padding = 0
                pad_all_ones = True
            else:
                padding += 1
                if bit == 0:
                    pad_all_ones = False
    if padding > 7:
        raise ValueError("huffman padding too long")
    # RFC 7541 5.2: an incomplete trailing code must be the EOS prefix.
    if padding and not pad_all_ones:
        raise ValueError("huffman padding is not an EOS prefix")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for b in data:
        code, n = _HUFFMAN_CODES[b]
        acc = (acc << n) | code
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


# -- integer / string primitives (RFC 7541 §5) ------------------------------

def encode_int(value: int, prefix_bits: int, first_byte: int = 0) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte | value])
    out = bytearray([first_byte | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return value, pos


def encode_str(s: str, huffman: bool = False) -> bytes:
    raw = s.encode("utf-8")
    if huffman:
        enc = huffman_encode(raw)
        if len(enc) < len(raw):
            return encode_int(len(enc), 7, 0x80) + enc
    return encode_int(len(raw), 7, 0x00) + raw


def decode_str(data: bytes, pos: int) -> Tuple[str, int]:
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise ValueError("hpack string extends past the header block")
    raw = data[pos: pos + length]
    pos += length
    if huff:
        raw = huffman_decode(raw)
    return raw.decode("utf-8", "replace"), pos


# -- encoder / decoder -------------------------------------------------------

class HpackEncoder:
    """Static-index + literal-without-indexing encoder (keeps the remote
    dynamic table untouched, so no synchronization state)."""

    def encode(self, headers: List[Tuple[str, str]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            idx = _STATIC_LOOKUP.get((name, value))
            if idx is not None and STATIC_TABLE[idx - 1][1] == value:
                out += encode_int(idx, 7, 0x80)  # fully indexed
                continue
            name_idx = _STATIC_LOOKUP.get((name, None))
            if name_idx is not None:
                out += encode_int(name_idx, 4, 0x00)  # literal w/o indexing
            else:
                out += b"\x00"
                out += encode_str(name)
            out += encode_str(value)
        return bytes(out)


class HpackDecoder:
    """Full decoder: static + dynamic table + huffman + size updates."""

    def __init__(self, max_table_size: int = 4096):
        self._dynamic: List[Tuple[str, str]] = []
        self._max_size = max_table_size
        self._size = 0

    def _entry(self, index: int) -> Tuple[str, str]:
        if index <= 0:
            raise ValueError("hpack index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        d = index - len(STATIC_TABLE) - 1
        if d >= len(self._dynamic):
            raise ValueError(f"hpack index {index} out of range")
        return self._dynamic[d]

    def _add(self, name: str, value: str):
        entry_size = len(name) + len(value) + 32
        self._dynamic.insert(0, (name, value))
        self._size += entry_size
        while self._size > self._max_size and self._dynamic:
            n, v = self._dynamic.pop()
            self._size -= len(n) + len(v) + 32

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        out = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed
                index, pos = decode_int(data, pos, 7)
                out.append(self._entry(index))
            elif b & 0x40:  # literal with incremental indexing
                index, pos = decode_int(data, pos, 6)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = decode_str(data, pos)
                value, pos = decode_str(data, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = decode_int(data, pos, 5)
                self._max_size = size
                while self._size > self._max_size and self._dynamic:
                    n, v = self._dynamic.pop()
                    self._size -= len(n) + len(v) + 32
            else:  # literal without indexing / never indexed (4-bit prefix)
                index, pos = decode_int(data, pos, 4)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = decode_str(data, pos)
                value, pos = decode_str(data, pos)
                out.append((name, value))
        return out
