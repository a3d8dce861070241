"""HTTP/2 and gRPC: unary gRPC calls over h2, on the RPC port.

Port of brpc_tpu/rpc/h2_protocol.py, byte-compatible with it: the h2
frames (HEADERS, CONTINUATION, DATA, SETTINGS, PING, WINDOW_UPDATE,
RST_STREAM, GOAWAY), header blocks by HPACK (rpc/hpack.py), a window per
connection and per stream with the sends that do not fit queued until a
WINDOW_UPDATE opens them, and the gRPC unary mapping: the 5-byte message
frame, ``grpc-status`` and ``grpc-message`` in the trailers,
``grpc-timeout`` both ways. It serves the same service and method map
the other protocols serve, through each method's MethodStatus, so the
limiter and ``/status`` count gRPC calls. No grpcio and no protobuf:
messages go through the port's codec (rpc/proto/wire.py).

Channels select it with ``ChannelOptions(protocol="h2:grpc")``. The
client's ``on_pinned`` hook (``ensure_client_conn``) sends the preface
and SETTINGS as the connection is made, before it joins the dispatcher:
an h2 server speaks first, and its SETTINGS must find ``sock.h2_conn``
there. A server connection is recognised by the preface, which may
arrive in pieces. The messages of a connection run in its reading task,
in wire order, and a server's handler runs there too (as in the
reference). Each attempt of a call opens a stream of its own.

One fault of the reference is not copied (ROADMAP queue C #22): its
server writes a response's trailers at once, even while the response's
DATA waits in ``pending_out`` for the peer's window, so a client whose
window is small gets the trailers first and the message cut short. The
port queues the trailers behind the stream's DATA. Frames of a
connection are written under its lock, so a flush on a WINDOW_UPDATE
and a handler that answers from another thread keep each stream's
order. ``frames_in`` counts the frames a connection read, by type.
"""
from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.hpack import HpackDecoder, HpackEncoder
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

F_DATA = 0x0
F_HEADERS = 0x1
F_PRIORITY = 0x2
F_RST_STREAM = 0x3
F_SETTINGS = 0x4
F_PUSH_PROMISE = 0x5
F_PING = 0x6
F_GOAWAY = 0x7
F_WINDOW_UPDATE = 0x8
F_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_ACK = 0x1
FLAG_PADDED = 0x8
FLAG_PRIORITY_F = 0x20

SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

DEFAULT_WINDOW = 65535
OUR_WINDOW = 1 << 28  # the receive window we advertise
MAX_FRAME = 16384

# gRPC status codes and the framework's errors, both ways
GRPC_OK = 0
GRPC_CANCELLED = 1
GRPC_DEADLINE_EXCEEDED = 4
GRPC_NOT_FOUND = 5
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_UNIMPLEMENTED = 12
GRPC_INTERNAL = 13
GRPC_UNAVAILABLE = 14
GRPC_UNAUTHENTICATED = 16

_ERR_TO_GRPC = {
    0: GRPC_OK,
    errors.ECANCELED: GRPC_CANCELLED,
    errors.ERPCTIMEDOUT: GRPC_DEADLINE_EXCEEDED,
    errors.ENOSERVICE: GRPC_NOT_FOUND,
    errors.ENOMETHOD: GRPC_UNIMPLEMENTED,
    errors.ELIMIT: GRPC_RESOURCE_EXHAUSTED,
    errors.EOVERLOAD: GRPC_RESOURCE_EXHAUSTED,
    errors.EAUTH: GRPC_UNAUTHENTICATED,
    errors.EFAILEDSOCKET: GRPC_UNAVAILABLE,
}
_GRPC_TO_ERR = {
    GRPC_OK: 0,
    GRPC_CANCELLED: errors.ECANCELED,
    GRPC_DEADLINE_EXCEEDED: errors.ERPCTIMEDOUT,
    GRPC_NOT_FOUND: errors.ENOSERVICE,
    GRPC_UNIMPLEMENTED: errors.ENOMETHOD,
    GRPC_RESOURCE_EXHAUSTED: errors.ELIMIT,
    GRPC_UNAUTHENTICATED: errors.EAUTH,
    GRPC_UNAVAILABLE: errors.EFAILEDSOCKET,
    GRPC_INTERNAL: errors.EINVAL,
}


def error_to_grpc_status(code: int) -> int:
    return _ERR_TO_GRPC.get(code, GRPC_INTERNAL)


def grpc_status_to_error(status: int) -> int:
    return _GRPC_TO_ERR.get(status, errors.EINVAL)


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    n = len(payload)
    return (bytes([(n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF, ftype,
                   flags]) + struct.pack(">I", stream_id & 0x7FFFFFFF)
            + payload)


def grpc_wrap(message: bytes) -> bytes:
    """The 5-byte gRPC message frame: a compressed flag and the length."""
    return b"\x00" + struct.pack(">I", len(message)) + message


def grpc_unwrap(data: bytes) -> Optional[bytes]:
    if len(data) < 5:
        return None
    (length,) = struct.unpack(">I", data[1:5])
    if len(data) < 5 + length:
        return None
    return data[5:5 + length]


class H2Stream:
    __slots__ = ("stream_id", "headers", "trailers", "data", "cid",
                 "send_window", "pending_out", "headers_done",
                 "pending_trailers")

    def __init__(self, stream_id: int, initial_window: int):
        self.stream_id = stream_id
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.data = bytearray()
        self.cid: Optional[int] = None
        self.send_window = initial_window
        self.pending_out: List[Tuple[bytes, bool]] = []  # (chunk, end)
        self.headers_done = False
        # the trailers' frame, sent when pending_out has drained
        self.pending_trailers: Optional[bytes] = None


class H2Connection:
    """The h2 state of one connection, on either side."""

    def __init__(self, is_client: bool):
        self.is_client = is_client
        self.encoder = HpackEncoder()
        self.decoder = HpackDecoder()
        self.streams: Dict[int, H2Stream] = {}
        self.next_stream_id = 1 if is_client else 2
        self.send_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.lock = threading.Lock()
        self._header_buf: Optional[Tuple[int, int, bytearray]] = None
        self.frames_in: Dict[int, int] = {}  # frame type -> frames read

    def new_stream(self) -> H2Stream:
        with self.lock:
            sid = self.next_stream_id
            self.next_stream_id += 2
            s = H2Stream(sid, self.peer_initial_window)
            self.streams[sid] = s
            return s

    def get_or_create(self, sid: int) -> H2Stream:
        with self.lock:
            s = self.streams.get(sid)
            if s is None:
                s = H2Stream(sid, self.peer_initial_window)
                self.streams[sid] = s
            return s

    def initial_frames(self) -> bytes:
        """Our SETTINGS and a WINDOW_UPDATE that opens the connection's
        receive window, after the preface on a client."""
        settings = struct.pack(">HI", SETTINGS_INITIAL_WINDOW_SIZE, OUR_WINDOW)
        settings += struct.pack(">HI", SETTINGS_MAX_FRAME_SIZE, MAX_FRAME)
        frames = pack_frame(F_SETTINGS, 0, 0, settings)
        frames += pack_frame(F_WINDOW_UPDATE, 0, 0,
                             struct.pack(">I", OUR_WINDOW - DEFAULT_WINDOW))
        if self.is_client:
            return PREFACE + frames
        return frames

    # -- sending with flow control ----------------------------------------
    def send_data(self, sock, stream: H2Stream, data: bytes, end: bool):
        """Send ``data`` in MAX_FRAME chunks as far as both windows allow;
        queue the rest, which a WINDOW_UPDATE flushes."""
        chunks: List[Tuple[bytes, bool]] = []
        pos = 0
        if not data:
            chunks.append((b"", end))
        while pos < len(data):
            take = min(MAX_FRAME, len(data) - pos)
            chunk = data[pos:pos + take]
            pos += take
            chunks.append((chunk, end and pos >= len(data)))
        out = IOBuf()
        with self.lock:
            for chunk, is_end in chunks:
                if (self.send_window >= len(chunk)
                        and stream.send_window >= len(chunk)
                        and not stream.pending_out):
                    self.send_window -= len(chunk)
                    stream.send_window -= len(chunk)
                    out.append(pack_frame(
                        F_DATA, FLAG_END_STREAM if is_end else 0,
                        stream.stream_id, chunk))
                else:
                    stream.pending_out.append((chunk, is_end))
            if not out.empty():
                sock.write(out)

    def send_trailers(self, sock, stream: H2Stream, frame: bytes):
        """The trailers go after the stream's last DATA frame: at once, or
        when its queued DATA has been flushed."""
        with self.lock:
            if stream.pending_out:
                stream.pending_trailers = frame
                return
            self.streams.pop(stream.stream_id, None)
            sock.write(IOBuf(frame))

    def flush_pending(self, sock):
        out = IOBuf()
        with self.lock:
            for s in list(self.streams.values()):
                while s.pending_out:
                    chunk, is_end = s.pending_out[0]
                    if (self.send_window < len(chunk)
                            or s.send_window < len(chunk)):
                        break
                    s.pending_out.pop(0)
                    self.send_window -= len(chunk)
                    s.send_window -= len(chunk)
                    out.append(pack_frame(
                        F_DATA, FLAG_END_STREAM if is_end else 0,
                        s.stream_id, chunk))
                if not s.pending_out and s.pending_trailers is not None:
                    out.append(s.pending_trailers)
                    s.pending_trailers = None
                    self.streams.pop(s.stream_id, None)
            if not out.empty():
                sock.write(out)


class H2Message(InputMessageBase):
    __slots__ = ("frames", "is_request")

    def __init__(self, frames):
        super().__init__()
        self.frames = frames
        self.is_request = True  # routed by the connection's role


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    conn: Optional[H2Connection] = getattr(sock, "h2_conn", None)
    if conn is None:
        # a server connection: the client's preface, whole or in part
        head = bytes(portal.copy_to_bytes(min(len(PREFACE), len(portal))))
        if not PREFACE.startswith(head):
            return ParseResult.try_others()
        if len(portal) < len(PREFACE):
            return ParseResult.not_enough()
        portal.pop_front(len(PREFACE))
        conn = H2Connection(is_client=False)
        sock.h2_conn = conn
        sock.write(IOBuf(conn.initial_frames()))
    frames = []
    while len(portal) >= 9:
        header = portal.copy_to_bytes(9)
        length = (header[0] << 16) | (header[1] << 8) | header[2]
        if len(portal) < 9 + length:
            break
        portal.pop_front(9)
        ftype, flags = header[3], header[4]
        (sid,) = struct.unpack(">I", header[5:9])
        sid &= 0x7FFFFFFF
        payload = bytes(portal.cutn_bytes(length))
        frames.append((ftype, flags, sid, payload))
    if not frames:
        return ParseResult.not_enough()
    return ParseResult.ok(H2Message(frames))


def process_frames(msg: H2Message):
    sock = msg.socket
    conn: H2Connection = getattr(sock, "h2_conn", None)
    if conn is None:
        return
    for ftype, flags, sid, payload in msg.frames:
        conn.frames_in[ftype] = conn.frames_in.get(ftype, 0) + 1
        if ftype == F_SETTINGS:
            if not (flags & FLAG_ACK):
                pos = 0
                while pos + 6 <= len(payload):
                    ident, value = struct.unpack_from(">HI", payload, pos)
                    pos += 6
                    if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                        with conn.lock:
                            delta = value - conn.peer_initial_window
                            conn.peer_initial_window = value
                            for s in conn.streams.values():
                                s.send_window += delta
                sock.write(IOBuf(pack_frame(F_SETTINGS, FLAG_ACK, 0, b"")))
        elif ftype == F_PING:
            if not (flags & FLAG_ACK):
                sock.write(IOBuf(pack_frame(F_PING, FLAG_ACK, 0, payload)))
        elif ftype == F_WINDOW_UPDATE:
            (incr,) = struct.unpack(">I", payload[:4])
            with conn.lock:
                if sid == 0:
                    conn.send_window += incr
                else:
                    s = conn.streams.get(sid)
                    if s is not None:
                        s.send_window += incr
            conn.flush_pending(sock)
        elif ftype in (F_HEADERS, F_CONTINUATION):
            block = payload
            if ftype == F_HEADERS:
                if flags & FLAG_PRIORITY_F:
                    block = block[5:]
                if flags & FLAG_PADDED:
                    pad = block[0]
                    block = block[1:len(block) - pad]
            if not (flags & FLAG_END_HEADERS):
                conn._header_buf = (sid, flags, bytearray(block))
                continue
            if conn._header_buf is not None and conn._header_buf[0] == sid:
                prev_sid, prev_flags, buf = conn._header_buf
                conn._header_buf = None
                buf.extend(block)
                block = bytes(buf)
                flags |= prev_flags
            headers = conn.decoder.decode(bytes(block))
            stream = conn.get_or_create(sid)
            if stream.headers_done:
                stream.trailers = headers
            else:
                stream.headers = headers
                stream.headers_done = True
            if flags & FLAG_END_STREAM:
                _on_stream_complete(sock, conn, stream)
        elif ftype == F_DATA:
            stream = conn.get_or_create(sid)
            body = payload
            if flags & FLAG_PADDED:
                pad = body[0]
                body = body[1:len(body) - pad]
            stream.data.extend(body)
            if len(payload):
                # give both windows back (we advertise a large one)
                upd = struct.pack(">I", len(payload))
                out = IOBuf(pack_frame(F_WINDOW_UPDATE, 0, 0, upd))
                out.append(pack_frame(F_WINDOW_UPDATE, 0, sid, upd))
                sock.write(out)
            if flags & FLAG_END_STREAM:
                _on_stream_complete(sock, conn, stream)
        elif ftype == F_RST_STREAM:
            stream = conn.streams.get(sid)
            if stream is not None and stream.cid is not None:
                bthread_id.error(stream.cid, errors.EFAILEDSOCKET,
                                 "h2 stream reset")
            with conn.lock:
                conn.streams.pop(sid, None)
        elif ftype == F_GOAWAY:
            last_sid = goaway_err = 0
            if len(payload) >= 8:
                (last_sid,) = struct.unpack(">I", payload[:4])
                last_sid &= 0x7FFFFFFF
                (goaway_err,) = struct.unpack(">I", payload[4:8])
            if conn.is_client and goaway_err == 0:
                # a graceful drain (RFC 7540 6.8): the streams up to
                # last_sid are still answered; the rest are refused (and
                # retried elsewhere), and no new stream opens here
                sock.mark_lame_duck()
                refused = []
                with conn.lock:
                    for rsid in [i for i in conn.streams if i > last_sid]:
                        st = conn.streams.pop(rsid)
                        if st.cid is not None:
                            refused.append(st.cid)
                for cid in refused:
                    bthread_id.error(cid, errors.EFAILEDSOCKET,
                                     "stream refused by GOAWAY")
            else:
                sock.set_failed(errors.ECLOSE, "h2 goaway")


def _headers_dict(headers) -> Dict[str, str]:
    return {k: v for k, v in (headers or [])}


def _on_stream_complete(sock, conn: H2Connection, stream: H2Stream):
    if conn.is_client:
        _complete_client_call(sock, conn, stream)
    else:
        _dispatch_server_request(sock, conn, stream)


# -- server side ------------------------------------------------------------

def _send_grpc_response(sock, conn: H2Connection, sid: int, payload: bytes,
                        grpc_status: int, grpc_message: str = ""):
    headers = [(":status", "200"), ("content-type", "application/grpc")]
    block = conn.encoder.encode(headers)
    sock.write(IOBuf(pack_frame(F_HEADERS, FLAG_END_HEADERS, sid, block)))
    stream = conn.get_or_create(sid)
    if payload:
        conn.send_data(sock, stream, grpc_wrap(payload), end=False)
    trailers = [("grpc-status", str(grpc_status))]
    if grpc_message:
        trailers.append(("grpc-message", grpc_message))
    tblock = conn.encoder.encode(trailers)
    conn.send_trailers(sock, stream, pack_frame(
        F_HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM, sid, tblock))


def _dispatch_server_request(sock, conn: H2Connection, stream: H2Stream):
    server = getattr(sock, "_h2_server", None)
    headers = _headers_dict(stream.headers)
    sid = stream.stream_id
    path = headers.get(":path", "/")
    parts = [p for p in path.split("/") if p]
    if server is None or len(parts) != 2:
        return _send_grpc_response(sock, conn, sid, b"", GRPC_UNIMPLEMENTED,
                                   f"bad path {path}")
    entry = server.find_method(parts[0], parts[1])
    if entry is None:
        missing_service = server.find_service(parts[0]) is None
        return _send_grpc_response(
            sock, conn, sid, b"",
            GRPC_NOT_FOUND if missing_service else GRPC_UNIMPLEMENTED,
            f"unknown method {path}")
    service_obj, minfo, method_status = entry
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl.service_name, cntl.method_name = parts[0], parts[1]
    cntl.server_start_time = time.monotonic()
    timeout = headers.get("grpc-timeout")
    if timeout:
        cntl.timeout_ms = _parse_grpc_timeout(timeout)
    if not method_status.on_requested():
        return _send_grpc_response(sock, conn, sid, b"",
                                   GRPC_RESOURCE_EXHAUSTED,
                                   "reached max_concurrency")
    request = minfo.request_class()
    body = grpc_unwrap(bytes(stream.data))
    try:
        if body:
            request.ParseFromString(body)
    except Exception as e:
        method_status.on_response(errors.EREQUEST, cntl.server_start_time)
        return _send_grpc_response(sock, conn, sid, b"", GRPC_INTERNAL,
                                   f"fail to parse request: {e}")
    response = minfo.response_class()
    responded = [False]

    def done():
        if responded[0]:
            return
        responded[0] = True
        method_status.on_response(cntl.error_code_value,
                                  cntl.server_start_time)
        if cntl.failed():
            _send_grpc_response(sock, conn, sid, b"",
                                error_to_grpc_status(cntl.error_code_value),
                                cntl.error_text_value)
        else:
            _send_grpc_response(sock, conn, sid,
                                response.SerializeToString(), GRPC_OK)

    try:
        minfo.handler(service_obj, cntl, request, response, done)
    except Exception as e:
        if not responded[0]:
            cntl.set_failed(errors.EINVAL, f"method raised: {e}")
            done()


def _parse_grpc_timeout(text: str) -> float:
    """A ``grpc-timeout`` value ("100m", "2S") in milliseconds."""
    unit = text[-1]
    value = float(text[:-1])
    scale = {"H": 3600e3, "M": 60e3, "S": 1e3, "m": 1.0, "u": 1e-3,
             "n": 1e-6}.get(unit, 1.0)
    return value * scale


# -- client side ------------------------------------------------------------

def serialize_request(request, cntl: Controller):
    if request is None:
        return b""
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    return request.SerializeToString()


_client_conn_lock = threading.Lock()  # guards the attachment, not the IO


def ensure_client_conn(sock) -> H2Connection:
    """Attach the client's H2Connection and send the preface and SETTINGS.
    Runs as the connection is made (the protocol's ``on_pinned`` hook,
    before the socket joins the dispatcher), or at the first request of a
    connection made without it."""
    conn = getattr(sock, "h2_conn", None)
    if conn is not None:
        return conn
    with _client_conn_lock:
        conn = getattr(sock, "h2_conn", None)
        if conn is None:
            conn = H2Connection(is_client=True)
            # the preface is queued before the connection is published: a
            # caller that finds h2_conn queues its HEADERS behind it
            sock.write(IOBuf(conn.initial_frames()))
            sock.h2_conn = conn
    return conn


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    sock = cntl._current_sock
    conn = ensure_client_conn(sock)
    out = IOBuf()
    stream = conn.new_stream()  # every attempt on a stream of its own
    stream.cid = correlation_id
    service, _, method = cntl._method_full_name.rpartition(".")
    headers = [
        (":method", "POST"), (":scheme", "http"),
        (":path", f"/{service}/{method}"),
        (":authority", str(cntl.remote_side or "")),
        ("content-type", "application/grpc"),
        ("te", "trailers"),
    ]
    if cntl._deadline is not None:
        remain_ms = max(1, int((cntl._deadline - time.monotonic()) * 1000))
        headers.append(("grpc-timeout", f"{remain_ms}m"))
    block = conn.encoder.encode(headers)
    out.append(pack_frame(F_HEADERS, FLAG_END_HEADERS, stream.stream_id,
                          block))
    body = grpc_wrap(payload)
    # DATA frames of at most MAX_FRAME (SETTINGS_MAX_FRAME_SIZE)
    pos = 0
    while True:
        take = min(MAX_FRAME, len(body) - pos)
        chunk = body[pos:pos + take]
        pos += take
        is_end = pos >= len(body)
        out.append(pack_frame(F_DATA, FLAG_END_STREAM if is_end else 0,
                              stream.stream_id, chunk))
        if is_end:
            break
    with conn.lock:
        conn.send_window -= len(body)
        stream.send_window -= len(body)
    return out


def _complete_client_call(sock, conn: H2Connection, stream: H2Stream):
    cid = stream.cid
    with conn.lock:
        conn.streams.pop(stream.stream_id, None)
    if cid is None:
        return
    try:
        cntl = bthread_id.lock(cid)
    except (KeyError, TimeoutError):
        return  # its RPC ended already
    if not isinstance(cntl, Controller):
        try:
            bthread_id.unlock(cid)
        except Exception:
            pass
        return
    trailers = _headers_dict(stream.trailers or stream.headers)
    status = int(trailers.get("grpc-status", "0") or 0)
    if status != GRPC_OK:
        cntl.set_failed(grpc_status_to_error(status),
                        trailers.get("grpc-message",
                                     f"grpc status {status}"))
        cntl._end_rpc(locked=True)
        return
    body = grpc_unwrap(bytes(stream.data))
    try:
        if cntl._response is not None and body:
            cntl._response.ParseFromString(body)
    except Exception as e:
        cntl.set_failed(errors.EREQUEST, f"fail to parse grpc response: {e}")
    cntl._end_rpc(locked=True)


def process_message(msg: H2Message):
    # a server connection learns its server from the message's arg
    if msg.arg is not None:
        msg.socket._h2_server = msg.arg
    process_frames(msg)


register_protocol(Protocol(
    name="h2:grpc",
    type=ProtocolType.H2,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_message,
    process_response=process_message,
    process_inline=True,  # frame order is load-bearing
    on_pinned=ensure_client_conn,
))
