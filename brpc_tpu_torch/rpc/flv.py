"""FLV — the container RTMP's media is dumped or served in.

Port of brpc_tpu/rpc/flv.py, byte-equal to it: an FLV tag is an RTMP
message's payload behind an 11-byte tag header, and its types are the
message types (8 audio, 9 video, 18 script data). ``FlvWriter`` writes
tags to a file-like object, ``read_tags`` reads them back and ``probe``
reads the file header.
"""
from __future__ import annotations

import struct
from typing import Iterator, Optional, Tuple

FLV_TAG_AUDIO = 8
FLV_TAG_VIDEO = 9
FLV_TAG_SCRIPT = 18

FLV_HEADER_AUDIO = 0x04
FLV_HEADER_VIDEO = 0x01


def file_header(has_audio: bool = True, has_video: bool = True) -> bytes:
    flags = (FLV_HEADER_AUDIO if has_audio else 0) | (
        FLV_HEADER_VIDEO if has_video else 0)
    #                 signature  ver  flags  header size   PreviousTagSize0
    return b"FLV" + bytes([1, flags]) + struct.pack(">I", 9) + b"\x00" * 4


def encode_tag(tag_type: int, timestamp_ms: int, payload: bytes) -> bytes:
    """One FLV tag + its trailing PreviousTagSize."""
    ts = timestamp_ms & 0xFFFFFFFF
    header = struct.pack(">B", tag_type)
    header += struct.pack(">I", len(payload))[1:]        # DataSize u24
    header += struct.pack(">I", ts & 0xFFFFFF)[1:]       # Timestamp u24
    header += bytes([(ts >> 24) & 0xFF])                 # TimestampExtended
    header += b"\x00\x00\x00"                            # StreamID
    return header + payload + struct.pack(">I", 11 + len(payload))


class FlvWriter:
    """Streams tags into a file-like object (the FlvWriter role)."""

    def __init__(self, fp, has_audio: bool = True, has_video: bool = True):
        self._fp = fp
        self._fp.write(file_header(has_audio, has_video))

    def write_tag(self, tag_type: int, timestamp_ms: int, payload: bytes):
        self._fp.write(encode_tag(tag_type, timestamp_ms, payload))

    def write_audio(self, timestamp_ms: int, payload: bytes):
        self.write_tag(FLV_TAG_AUDIO, timestamp_ms, payload)

    def write_video(self, timestamp_ms: int, payload: bytes):
        self.write_tag(FLV_TAG_VIDEO, timestamp_ms, payload)

    def write_metadata(self, timestamp_ms: int, payload: bytes):
        self.write_tag(FLV_TAG_SCRIPT, timestamp_ms, payload)


def read_tags(data: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yields (tag_type, timestamp_ms, payload) from an FLV byte string
    (the FlvReader role)."""
    if data[:3] != b"FLV":
        raise ValueError("not an FLV stream")
    header_size = struct.unpack(">I", data[5:9])[0]
    pos = header_size + 4  # skip PreviousTagSize0
    n = len(data)
    while pos + 11 <= n:
        tag_type = data[pos]
        size = struct.unpack(">I", b"\x00" + data[pos + 1:pos + 4])[0]
        ts = struct.unpack(">I", b"\x00" + data[pos + 4:pos + 7])[0]
        ts |= data[pos + 7] << 24
        body_at = pos + 11
        if body_at + size > n:
            return  # truncated tail
        yield tag_type, ts, data[body_at:body_at + size]
        pos = body_at + size + 4  # skip PreviousTagSize


def probe(data: bytes) -> Optional[dict]:
    """Quick sanity probe: header flags + first-tag info, or None."""
    if len(data) < 13 or data[:3] != b"FLV":
        return None
    return {"version": data[3], "has_audio": bool(data[4] & 4),
            "has_video": bool(data[4] & 1)}
