"""Stream frames — the wire format of Streams.

Port of brpc_tpu/rpc/streaming_protocol.py (streaming_rpc_protocol.cpp's
role): ``"TSTR"`` and a big-endian 4-byte body size, then the body: the
destination stream id and the frame type (``>QB``), then the payload.
DATA carries a message, FEEDBACK the bytes the receiver consumed (its
window update), CLOSE ends the stream. A frame addresses the stream
endpoint of the side that receives it: each side learned the other's id
in the RPC that set the stream up. Frames are processed inline, in the
reading task, so a stream sees them in wire order.
"""
from __future__ import annotations

import struct

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

MAGIC = b"TSTR"
HEADER_LEN = 8  # magic + body_size
FRAME_DATA = 0
FRAME_FEEDBACK = 1
FRAME_CLOSE = 2


def _pack(dest_id: int, ftype: int, payload: IOBuf) -> IOBuf:
    body_size = 9 + len(payload)  # 8 B destination id + 1 B type
    out = IOBuf()
    out.append(MAGIC + struct.pack(">I", body_size)
               + struct.pack(">QB", dest_id, ftype))
    if len(payload):
        out.append(payload)
    return out


def pack_data_frame(dest_id: int, payload: IOBuf) -> IOBuf:
    return _pack(dest_id, FRAME_DATA, payload)


def pack_feedback_frame(dest_id: int, consumed: int) -> IOBuf:
    return _pack(dest_id, FRAME_FEEDBACK, IOBuf(struct.pack(">Q", consumed)))


def pack_close_frame(dest_id: int) -> IOBuf:
    return _pack(dest_id, FRAME_CLOSE, IOBuf())


class StreamFrame(InputMessageBase):
    __slots__ = ("dest_id", "ftype", "payload", "is_request")

    def __init__(self, dest_id: int, ftype: int, payload: IOBuf):
        super().__init__()
        self.dest_id = dest_id
        self.ftype = ftype
        self.payload = payload
        self.is_request = True  # routed by stream id, not by role


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if len(portal) < HEADER_LEN:
        head = portal.copy_to_bytes(min(4, len(portal)))
        if MAGIC.startswith(head):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    header = portal.copy_to_bytes(HEADER_LEN)
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    (body_size,) = struct.unpack(">I", header[4:8])
    if body_size < 9 or body_size > (1 << 31):
        return ParseResult.error_()
    if len(portal) < HEADER_LEN + body_size:
        return ParseResult.not_enough()
    portal.pop_front(HEADER_LEN)
    dest_id, ftype = struct.unpack(">QB", portal.cutn_bytes(9))
    payload = portal.cut(body_size - 9)
    return ParseResult.ok(StreamFrame(dest_id, ftype, payload))


def process_frame(msg: StreamFrame):
    from brpc_tpu_torch.rpc.stream import Stream

    stream = Stream.find(msg.dest_id)
    if stream is None:
        return  # closed already: dropped, as in the reference
    if msg.ftype == FRAME_DATA:
        stream._on_data(msg.payload)
    elif msg.ftype == FRAME_FEEDBACK:
        (consumed,) = struct.unpack(">Q", msg.payload.to_bytes())
        stream._on_feedback(consumed)
    elif msg.ftype == FRAME_CLOSE:
        stream.close(notify_remote=False)


register_protocol(Protocol(
    name="streaming",
    type=ProtocolType.STREAMING,
    parse=parse,
    process_request=process_frame,
    process_response=process_frame,
    process_inline=True,  # a stream's frames run in wire order
))
