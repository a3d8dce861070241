"""MPEG-TS — RTMP's media in 188-byte transport-stream packets.

Port of brpc_tpu/rpc/mpegts.py, byte-equal to it: PAT and PMT with the
MPEG CRC-32, PES packets with a PTS, a PCR on the video PID (the first
access unit and every keyframe), continuity counters and stuffing
through the adaptation field: the container of HLS segments. One
program of H.264 (stream type 0x1B) and AAC (0x0F). ``demux``
reassembles the PES payloads by PID.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

TS_PACKET = 188
SYNC = 0x47

PID_PAT = 0x0000
PID_PMT = 0x1000
PID_VIDEO = 0x0100
PID_AUDIO = 0x0101

STREAM_TYPE_H264 = 0x1B
STREAM_TYPE_AAC = 0x0F

PES_SID_VIDEO = 0xE0
PES_SID_AUDIO = 0xC0


def _crc32_mpeg(data: bytes) -> int:
    """CRC32/MPEG-2 (poly 0x04C11DB7, init 0xFFFFFFFF, no reflection)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def _psi_packet(pid: int, table: bytes, cc: int) -> bytes:
    """One TS packet carrying a PSI section (pointer_field form)."""
    header = struct.pack(">BHB", SYNC, 0x4000 | pid,  # PUSI set
                         0x10 | (cc & 0x0F))          # payload only
    payload = b"\x00" + table  # pointer_field = 0
    pad = TS_PACKET - 4 - len(payload)
    return header + payload + b"\xff" * pad


def _pat_table() -> bytes:
    # one 4-byte program entry: program_number, reserved(3)+PMT PID
    body = struct.pack(">HH", 1, 0xE000 | PID_PMT)
    # table_id 0, section_syntax, length = body after this field + crc
    sec = struct.pack(">BH", 0x00, 0xB000 | (len(body) + 5 + 4))
    sec += struct.pack(">HBBB", 1, 0xC1, 0, 0)  # tsid, ver/cur, sec, last
    sec += body
    sec += struct.pack(">I", _crc32_mpeg(sec))
    return sec


def _pmt_table(has_audio: bool) -> bytes:
    streams = struct.pack(">BHH", STREAM_TYPE_H264, 0xE000 | PID_VIDEO,
                          0xF000 | 0)
    if has_audio:
        streams += struct.pack(">BHH", STREAM_TYPE_AAC, 0xE000 | PID_AUDIO,
                               0xF000 | 0)
    body = struct.pack(">HH", 0xE000 | PID_VIDEO, 0xF000 | 0)  # PCR + pinfo
    body += streams
    sec = struct.pack(">BH", 0x02, 0xB000 | (len(body) + 5 + 4))
    sec += struct.pack(">HBBB", 1, 0xC1, 0, 0)  # program, ver/cur, sec, last
    sec += body
    sec += struct.pack(">I", _crc32_mpeg(sec))
    return sec


def _pts_field(pts: int, marker: int) -> bytes:
    pts &= (1 << 33) - 1
    return bytes([
        (marker << 4) | (((pts >> 30) & 0x7) << 1) | 1,
        (pts >> 22) & 0xFF,
        (((pts >> 15) & 0x7F) << 1) | 1,
        (pts >> 7) & 0xFF,
        ((pts & 0x7F) << 1) | 1,
    ])


def _pes(stream_id: int, pts_90k: int, payload: bytes) -> bytes:
    header = b"\x00\x00\x01" + bytes([stream_id])
    flags = b"\x80\x80\x05" + _pts_field(pts_90k, 0x2)  # PTS only
    length = len(flags) + len(payload)
    if length > 0xFFFF:
        if stream_id == PES_SID_VIDEO:
            length = 0  # unbounded video PES is legal
        else:
            raise ValueError(
                f"ts: audio PES payload too large ({len(payload)} bytes); "
                "split frames above 65527 bytes")
    return header + struct.pack(">H", length) + flags + payload


class TsMuxer:
    """Streams (pid, pts_ms, es_payload) into 188-byte packets. Call
    write_video/write_audio per access unit; packets() yields the bytes
    (PAT+PMT are emitted at start and can be re-emitted via write_psi
    for segment boundaries)."""

    def __init__(self, has_audio: bool = True):
        self._cc: Dict[int, int] = {PID_PAT: 0, PID_PMT: 0,
                                    PID_VIDEO: 0, PID_AUDIO: 0}
        self._out: List[bytes] = []
        self.has_audio = has_audio
        self._pcr_sent = False  # PMT advertises PCR on the video PID:
        self.write_psi()        # at least one PCR must actually appear

    def write_psi(self):
        self._out.append(_psi_packet(PID_PAT, _pat_table(),
                                     self._bump(PID_PAT)))
        self._out.append(_psi_packet(PID_PMT, _pmt_table(self.has_audio),
                                     self._bump(PID_PMT)))

    def _bump(self, pid: int) -> int:
        cc = self._cc[pid]
        self._cc[pid] = (cc + 1) & 0x0F
        return cc

    def _emit_pes(self, pid: int, sid: int, pts_ms: int, payload: bytes,
                  pcr: bool):
        pes = _pes(sid, pts_ms * 90, payload)
        pos = 0
        first = True
        while pos < len(pes) or first:
            remaining = len(pes) - pos
            cc = self._bump(pid)
            flags2 = 0x10 | (cc & 0x0F)  # payload present
            adaptation = b""
            if first and pcr:
                pcr_base = (pts_ms * 90) & ((1 << 33) - 1)
                adaptation = bytes([7, 0x10]) + bytes([
                    (pcr_base >> 25) & 0xFF, (pcr_base >> 17) & 0xFF,
                    (pcr_base >> 9) & 0xFF, (pcr_base >> 1) & 0xFF,
                    ((pcr_base & 1) << 7) | 0x7E, 0x00])
            room = TS_PACKET - 4 - len(adaptation)
            if remaining < room:
                # stuff via adaptation field so the packet fills exactly
                stuff = room - remaining
                if adaptation:
                    adaptation = (bytes([adaptation[0] + stuff])
                                  + adaptation[1:] + b"\xff" * stuff)
                elif stuff == 1:
                    adaptation = bytes([0])
                else:
                    adaptation = bytes([stuff - 1, 0x00]) + b"\xff" * (
                        stuff - 2)
            if adaptation:
                flags2 |= 0x20
            header = struct.pack(
                ">BHB", SYNC, (0x4000 if first else 0) | pid, flags2)
            take = TS_PACKET - 4 - len(adaptation)
            chunk = pes[pos:pos + take]
            self._out.append(header + adaptation + chunk)
            pos += take
            first = False

    def write_video(self, pts_ms: int, es: bytes, keyframe: bool = False):
        # the first access unit always carries a PCR (consumers cannot
        # establish a clock from a PCR-less stream, TR 101 290), then
        # keyframes refresh it
        pcr = keyframe or not self._pcr_sent
        self._pcr_sent = True
        self._emit_pes(PID_VIDEO, PES_SID_VIDEO, pts_ms, es, pcr=pcr)

    def write_audio(self, pts_ms: int, es: bytes):
        if not self.has_audio:
            raise ValueError("muxer created without an audio stream")
        self._emit_pes(PID_AUDIO, PES_SID_AUDIO, pts_ms, es, pcr=False)

    def packets(self) -> bytes:
        out = b"".join(self._out)
        self._out = []
        return out


def demux(data: bytes) -> Iterator[Tuple[int, Optional[int], bytes]]:
    """Yields (pid, pts_ms or None, es_payload) per completed PES packet;
    PSI pids are skipped. Raises ValueError on sync loss."""
    if len(data) % TS_PACKET != 0:
        raise ValueError(
            f"ts: truncated stream ({len(data)} bytes is not a multiple "
            f"of {TS_PACKET})")
    assembling: Dict[int, List[bytes]] = {}
    for off in range(0, len(data), TS_PACKET):
        pkt = data[off:off + TS_PACKET]
        if pkt[0] != SYNC:
            raise ValueError(f"ts: sync loss at offset {off}")
        pusi = bool(pkt[1] & 0x40)
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        afc = (pkt[3] >> 4) & 0x3
        pos = 4
        if afc & 0x2:  # adaptation field
            pos += 1 + pkt[4]
        if not afc & 0x1:
            continue  # no payload
        if pid in (PID_PAT, PID_PMT):
            continue
        payload = pkt[pos:]
        if pusi:
            if pid in assembling:
                yield _finish_pes(pid, b"".join(assembling.pop(pid)))
            assembling[pid] = [payload]
        elif pid in assembling:
            assembling[pid].append(payload)
    for pid, parts in assembling.items():
        yield _finish_pes(pid, b"".join(parts))


def _finish_pes(pid: int, pes: bytes) -> Tuple[int, Optional[int], bytes]:
    if len(pes) < 9:
        raise ValueError("ts: truncated PES header")
    if pes[:3] != b"\x00\x00\x01":
        raise ValueError("ts: bad PES start code")
    flags = pes[7]
    hlen = pes[8]
    if len(pes) < 9 + hlen or (flags & 0x80 and hlen < 5):
        raise ValueError("ts: truncated PES optional header")
    pts_ms = None
    if flags & 0x80:
        p = pes[9:14]
        pts = (((p[0] >> 1) & 0x7) << 30) | (p[1] << 22) | \
            ((p[2] >> 1) << 15) | (p[3] << 7) | (p[4] >> 1)
        pts_ms = pts // 90
    return pid, pts_ms, pes[9 + hlen:]
