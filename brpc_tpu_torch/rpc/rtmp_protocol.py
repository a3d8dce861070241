"""RTMP — the media-streaming protocol, server side, and its live relay.

Port of brpc_tpu/rpc/rtmp_protocol.py, with its wire bytes:

* the handshake: the simple one (S2 echoes C1), and the digest one when
  C1 carries the Flash Player digest (rpc/rtmp_client.py's keys);
* the chunk stream: basic header fmt 0-3 with one-, two- and three-byte
  csids, message assembly per csid, extended timestamps (on fmt-3 chunks
  too), ``SetChunkSize`` both ways (4096 out, 128 in until the peer says
  otherwise), Abort, WindowAckSize, SetPeerBW, Ack, UserControl ping and
  pong;
* AMF0 commands: ``connect``, ``createStream``,
  ``releaseStream``/``FCPublish``/``FCUnpublish``, ``publish``, ``play``,
  ``deleteStream``;
* ``RtmpService``: one live publisher per stream name, any number of
  players; metadata and the AVC and AAC sequence headers cached and sent
  to a late joiner before its first live frame; names reaped when their
  last session leaves; a player whose socket holds more than
  ``MAX_PLAYER_BACKLOG`` unwritten bytes is shed (its socket failed);
* ``RtmpClientSession`` and ``rtmp_client_connect``: the same chunk
  machinery driven from the client side.

A connection is claimed when its first byte is 0x03, on a server whose
``ServerOptions.rtmp_service`` is set (rpc/protocol.py tries RTMP last);
elsewhere the bytes go to the other protocols. The whole conversation
runs inside ``parse``, in the connection's reading task: a publisher's
task writes each frame to every player's socket, while each player's
task writes its own command replies there. ``Socket.write`` queues a
whole message and the session's ``_wlock`` orders the writers, so every
message's chunks stay contiguous on the wire. The portal is drained into
the session's ``pending`` bytes once per byte read.

Two repairs of the reference (ROADMAP queue C): a server session leaves
its relay when its socket fails (``on_protocol_failed``), so a
publisher or player that hangs up without ``deleteStream`` frees its
name; ``rtmp_sessions`` counts the server sessions alive, where the
reference counts every session ever made. ``rtmp_messages`` counts the
messages read and ``rtmp_relayed_messages`` the messages relayed to
players.
"""
from __future__ import annotations

import os
import socket as pysocket
import struct
import threading
import time
from typing import Dict, List, Optional

from brpc_tpu_torch import bvar
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import amf
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

HANDSHAKE_SIZE = 1536
DEFAULT_IN_CHUNK = 128  # the spec's default until the peer says otherwise
OUT_CHUNK = 4096

MSG_SET_CHUNK_SIZE = 1
MSG_ABORT = 2
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

UC_STREAM_BEGIN = 0
UC_PING = 6
UC_PONG = 7

_rtmp_sessions = bvar.Adder("rtmp_sessions")
_rtmp_messages = bvar.Adder("rtmp_messages")
_rtmp_relayed = bvar.Adder("rtmp_relayed_messages")


class RtmpMessage(InputMessageBase):
    """A placeholder: RTMP is handled inside parse; the cut loop only
    counts progress."""

    __slots__ = ("is_request",)

    def __init__(self):
        super().__init__()
        self.is_request = True


# -- the relay ---------------------------------------------------------------

class _LiveStream:
    def __init__(self, name: str):
        self.name = name
        self.publisher: Optional["RtmpSession"] = None
        self.players: List[RtmpSession] = []
        self.metadata: Optional[bytes] = None  # AMF0 onMetaData
        self.avc_seq_header: Optional[bytes] = None  # the video config
        self.aac_seq_header: Optional[bytes] = None  # the audio config


class RtmpService:
    """A publish-to-play relay in memory: one live publisher per stream
    name, any number of players."""

    # a player this far behind is shed rather than buffered further
    MAX_PLAYER_BACKLOG = 8 << 20

    def __init__(self):
        self._streams: Dict[str, _LiveStream] = {}
        self._lock = threading.Lock()

    def _stream_locked(self, name: str) -> _LiveStream:
        # the caller holds self._lock: get-or-create and the change that
        # follows share one acquisition, or drop's reaping could orphan it
        st = self._streams.get(name)
        if st is None:
            st = self._streams[name] = _LiveStream(name)
        return st

    def on_publish(self, name: str, sess: "RtmpSession") -> bool:
        """Claim ``name`` for ``sess``; False while another publisher of
        it is alive (a failed socket releases the name)."""
        with self._lock:
            st = self._stream_locked(name)
            cur = st.publisher
            if cur is not None and cur is not sess and not cur.sock.failed():
                return False
            st.publisher = sess
        return True

    def release_publisher(self, name: str, sess: "RtmpSession"):
        """Free the name (FCUnpublish, or a publish of another name) while
        the session lives."""
        with self._lock:
            st = self._streams.get(name)
            if st is not None and st.publisher is sess:
                st.publisher = None
                if not st.players:
                    del self._streams[name]

    def on_play(self, name: str, sess: "RtmpSession"):
        """Register the player and send it the cached metadata and
        sequence headers in the same critical section, so no relayed
        frame reaches it ahead of them. A second play moves the player."""
        with self._lock:
            st = self._stream_locked(name)
            for other in self._streams.values():
                if other is not st and sess in other.players:
                    other.players.remove(sess)
            if sess not in st.players:
                st.players.append(sess)
            if st.metadata is not None:
                sess.send_message(MSG_DATA_AMF0, 0, st.metadata, stream_id=1)
            if st.avc_seq_header is not None:
                sess.send_message(MSG_VIDEO, 0, st.avc_seq_header,
                                  stream_id=1)
            if st.aac_seq_header is not None:
                sess.send_message(MSG_AUDIO, 0, st.aac_seq_header,
                                  stream_id=1)

    def on_media(self, name: str, msg_type: int, ts: int, payload: bytes):
        """Cache what a late joiner needs, then write the message to every
        player, shedding a failed or stalled one."""
        with self._lock:
            st = self._stream_locked(name)
            if msg_type == MSG_DATA_AMF0:
                st.metadata = payload
            elif (msg_type == MSG_VIDEO and len(payload) >= 2
                    and (payload[0] & 0x0F) == 7 and payload[1] == 0):
                st.avc_seq_header = payload
            elif (msg_type == MSG_AUDIO and len(payload) >= 2
                    and (payload[0] >> 4) == 10 and payload[1] == 0):
                st.aac_seq_header = payload
            players = list(st.players)
        for p in players:
            if p.sock.failed():
                self.drop(p)
                continue
            # one slow consumer must not grow the relay's memory without
            # bound while the publisher keeps pushing
            if p.sock.write_backlog_bytes() > self.MAX_PLAYER_BACKLOG:
                p.sock.set_failed()
                self.drop(p)
                continue
            try:
                p.send_message(msg_type, ts, payload, stream_id=1)
                _rtmp_relayed.update(1)
            except Exception:
                self.drop(p)

    def drop(self, sess: "RtmpSession"):
        """Take the session out of every stream; reap the names left with
        neither a publisher nor a player."""
        with self._lock:
            dead = []
            for name, st in self._streams.items():
                if st.publisher is sess:
                    st.publisher = None
                if sess in st.players:
                    st.players.remove(sess)
                if st.publisher is None and not st.players:
                    dead.append(name)
            for name in dead:
                del self._streams[name]

    def stream_names(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)


# -- one connection: the handshake and the chunk stream ----------------------

class _CsidState:
    __slots__ = ("timestamp", "length", "msg_type", "stream_id", "delta",
                 "has_ext_ts", "buf")

    def __init__(self):
        self.timestamp = 0
        self.length = 0
        self.msg_type = 0
        self.stream_id = 0
        self.delta = 0
        self.has_ext_ts = False  # fmt-3 chunks read the ext timestamp again
        self.buf = bytearray()


class RtmpSession:
    ST_WAIT_C0C1 = 0
    ST_WAIT_C2 = 1
    ST_ESTABLISHED = 2

    def __init__(self, sock, service: RtmpService):
        self.sock = sock
        self.service = service
        self.state = self.ST_WAIT_C0C1
        self.in_chunk = DEFAULT_IN_CHUNK
        self.out_chunk = OUT_CHUNK
        self.csid_state: Dict[int, _CsidState] = {}
        self.publishing: Optional[str] = None
        self.playing: Optional[str] = None
        # bytes read and not yet consumed: each byte enters once, what is
        # left of an unfinished unit stays for the next read
        self.pending = bytearray()
        self._wlock = threading.Lock()  # relay writers vs command replies

    # -- outbound ----------------------------------------------------------
    def _write(self, data: bytes):
        self.sock.write(IOBuf(data))

    def send_message(self, msg_type: int, ts: int, payload: bytes,
                     stream_id: int = 0, csid: int = 3):
        """Chunk one message: a fmt-0 chunk, then fmt-3 continuations."""
        ts = ts & 0xFFFFFFFF
        header_ts = min(ts, 0xFFFFFF)
        out = bytearray()
        out.append(csid)  # fmt 0, one-byte basic header (csid < 64)
        out += struct.pack(">I", header_ts)[1:]
        out += struct.pack(">I", len(payload))[1:]
        out.append(msg_type)
        out += struct.pack("<I", stream_id)
        ext = struct.pack(">I", ts) if header_ts == 0xFFFFFF else b""
        out += ext
        pos = 0
        first = True
        while pos < len(payload) or first:
            if not first:
                out.append((3 << 6) | csid)
                out += ext
            take = min(self.out_chunk, len(payload) - pos)
            out += payload[pos:pos + take]
            pos += take
            first = False
        with self._wlock:
            self._write(bytes(out))

    def send_command(self, *values, stream_id: int = 0, csid: int = 3):
        self.send_message(MSG_COMMAND_AMF0, 0, amf.encode_many(*values),
                          stream_id=stream_id, csid=csid)

    def _send_control(self, msg_type: int, payload: bytes):
        self.send_message(msg_type, 0, payload, stream_id=0, csid=2)

    def send_onstatus(self, code: str, level: str = "status",
                      stream_id: int = 1):
        self.send_command("onStatus", 0.0, None,
                          {"level": level, "code": code, "description": code},
                          stream_id=stream_id, csid=5)

    # -- inbound -----------------------------------------------------------
    def feed_bytes(self, data) -> bool:
        """Append ``data`` and consume what is complete; True when a
        handshake or chunk unit was consumed."""
        self.pending += data
        used = self.consume(self.pending)
        if used:
            del self.pending[:used]
        return used > 0

    def consume(self, data: bytearray) -> int:
        """Eat every complete handshake or chunk unit at the front of
        ``data``; the bytes consumed. Raises ValueError on a protocol
        error (the caller fails the connection)."""
        used = 0
        while True:
            n = self._consume_one(data, used)
            if n == 0:
                return used
            used += n

    def _consume_one(self, data: bytearray, pos: int) -> int:
        avail = len(data) - pos
        if self.state == self.ST_WAIT_C0C1:
            if avail < 1 + HANDSHAKE_SIZE:
                return 0
            if data[pos] != 3:
                raise ValueError("rtmp: unsupported handshake version")
            c1 = bytes(data[pos + 1:pos + 1 + HANDSHAKE_SIZE])
            # a nonzero version field: the client expects the digest
            # handshake (S1 keyed by the Media Server key, S2 chained from
            # C1's digest); a plain C1 gets the simple echo
            found = None
            if c1[4:8] != b"\x00\x00\x00\x00":
                from brpc_tpu_torch.rpc import rtmp_client as rc

                found = rc.find_digest(c1, rc.FP_KEY)
            if found is not None:
                scheme, c1_digest = found
                s1, _ = rc.make_digest_s1(scheme)
                s2 = rc.make_chained_reply(c1_digest, rc.FMS_KEY_FULL)
                self._write(bytes([3]) + s1 + s2)
            else:
                s1 = c1[:8] + os.urandom(HANDSHAKE_SIZE - 8)
                self._write(bytes([3]) + s1 + c1)  # S0, S1, S2 = C1
            self.state = self.ST_WAIT_C2
            return 1 + HANDSHAKE_SIZE
        if self.state == self.ST_WAIT_C2:
            if avail < HANDSHAKE_SIZE:
                return 0
            self.state = self.ST_ESTABLISHED
            return HANDSHAKE_SIZE
        return self._consume_chunk(data, pos)

    def _consume_chunk(self, data: bytearray, pos: int) -> int:
        start = pos
        avail = len(data)
        if pos >= avail:
            return 0
        b0 = data[pos]
        fmt = b0 >> 6
        csid = b0 & 0x3F
        pos += 1
        if csid == 0:
            if pos >= avail:
                return 0
            csid = 64 + data[pos]
            pos += 1
        elif csid == 1:
            if pos + 2 > avail:
                return 0
            csid = 64 + data[pos] + (data[pos + 1] << 8)
            pos += 2
        st = self.csid_state.get(csid)
        if st is None:
            st = self.csid_state[csid] = _CsidState()
        need = (11, 7, 3, 0)[fmt]
        if pos + need > avail:
            return 0
        ts_field = None
        if fmt == 0:
            ts_field = int.from_bytes(data[pos:pos + 3], "big")
            st.length = int.from_bytes(data[pos + 3:pos + 6], "big")
            st.msg_type = data[pos + 6]
            st.stream_id = int.from_bytes(data[pos + 7:pos + 11], "little")
            pos += 11
        elif fmt == 1:
            ts_field = int.from_bytes(data[pos:pos + 3], "big")
            st.length = int.from_bytes(data[pos + 3:pos + 6], "big")
            st.msg_type = data[pos + 6]
            st.delta = ts_field
            pos += 7
        elif fmt == 2:
            ts_field = int.from_bytes(data[pos:pos + 3], "big")
            st.delta = ts_field
            pos += 3
        if ts_field is not None:
            st.has_ext_ts = ts_field == 0xFFFFFF
        # fmt-3 chunks of a message whose header used the extended
        # timestamp carry the 4-byte field again (spec 5.3.1.3)
        ext = 0
        if st.has_ext_ts:
            if pos + 4 > avail:
                return 0
            ext = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
        if st.length > (64 << 20):
            raise ValueError("rtmp: message too large")
        continuation = fmt == 3 and len(st.buf) > 0
        if not continuation and len(st.buf) > 0:
            # a fresh header on a csid with an unfinished message
            raise ValueError("rtmp: new message before finishing the "
                             "previous one on this chunk stream")
        new_ts = st.timestamp
        if not continuation:
            # a fresh chunk advances the timestamp (fmt 3 repeats the
            # previous header: the same delta applies again)
            if fmt == 0:
                new_ts = ext if st.has_ext_ts else ts_field
            else:
                new_ts = st.timestamp + (ext if st.has_ext_ts else st.delta)
        take = min(self.in_chunk, st.length - len(st.buf))
        if pos + take > avail:
            return 0  # incomplete: nothing committed, so a reparse after
            # more bytes arrive does not advance the timestamp twice
        st.timestamp = new_ts
        if fmt == 0 and not continuation:
            # fmt 0's absolute timestamp becomes the delta a following
            # fmt-3 new message advances by (spec 5.3.1.2.4)
            st.delta = ext if st.has_ext_ts else ts_field
        st.buf += data[pos:pos + take]
        pos += take
        if len(st.buf) >= st.length:
            body = bytes(st.buf)
            st.buf = bytearray()
            self._on_message(st.msg_type, st.stream_id, st.timestamp, body)
        return pos - start

    # -- dispatch ----------------------------------------------------------
    def _on_message(self, msg_type: int, stream_id: int, ts: int,
                    payload: bytes):
        _rtmp_messages.update(1)
        if msg_type == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
            size = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            if not 1 <= size <= (16 << 20):
                raise ValueError("rtmp: bad chunk size")
            self.in_chunk = size
        elif msg_type == MSG_USER_CONTROL and len(payload) >= 2:
            event = struct.unpack(">H", payload[:2])[0]
            if event == UC_PING:
                self._send_control(MSG_USER_CONTROL,
                                   struct.pack(">H", UC_PONG) + payload[2:])
        elif msg_type == MSG_ABORT and len(payload) >= 4:
            # spec 5.4.2: discard the message being assembled
            stx = self.csid_state.get(struct.unpack(">I", payload[:4])[0])
            if stx is not None:
                stx.buf = bytearray()
        elif msg_type in (MSG_WINDOW_ACK_SIZE, MSG_SET_PEER_BW, MSG_ACK):
            pass  # flow-control bookkeeping nothing here acts on
        elif msg_type == MSG_COMMAND_AMF0:
            self._on_command(stream_id, payload)
        elif msg_type in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            if self.publishing is not None:
                self.service.on_media(self.publishing, msg_type, ts, payload)

    def _on_command(self, stream_id: int, payload: bytes):
        try:
            values = amf.decode_all(payload)
        except amf.AmfError as e:
            raise ValueError(f"rtmp: bad AMF0 command: {e}")
        if not values or not isinstance(values[0], str):
            return
        cmd = values[0]
        txn = values[1] if len(values) > 1 else 0.0
        if cmd == "connect":
            self._send_control(MSG_WINDOW_ACK_SIZE, struct.pack(">I", 2500000))
            self._send_control(MSG_SET_PEER_BW,
                               struct.pack(">IB", 2500000, 2))
            self._send_control(MSG_SET_CHUNK_SIZE,
                               struct.pack(">I", self.out_chunk))
            self.send_command(
                "_result", txn,
                {"fmsVer": "FMS/3,5,3,888", "capabilities": 127.0},
                {"level": "status", "code": "NetConnection.Connect.Success",
                 "description": "Connection succeeded.",
                 "objectEncoding": 0.0})
        elif cmd == "createStream":
            self.send_command("_result", txn, None, 1.0)
        elif cmd in ("releaseStream", "FCPublish", "FCUnpublish",
                     "getStreamLength"):
            uname = values[3] if len(values) > 3 else None
            if isinstance(uname, str):
                uname = uname.split("?")[0]
            if (cmd == "FCUnpublish" and self.publishing is not None
                    and (uname is None or uname == self.publishing)):
                # a stale FCUnpublish of another name must not end the
                # live stream
                self.service.release_publisher(self.publishing, self)
                self.publishing = None
            self.send_command("_result", txn, None, None)
        elif cmd == "publish":
            name = values[3] if len(values) > 3 else ""
            if not isinstance(name, str) or not name:
                raise ValueError("rtmp: publish without a stream name")
            name = name.split("?")[0]
            if not self.service.on_publish(name, self):
                self.send_onstatus("NetStream.Publish.BadName", level="error")
                return  # the old name stays published
            if self.publishing is not None and self.publishing != name:
                # released only once the new claim holds
                self.service.release_publisher(self.publishing, self)
            self.publishing = name
            self.send_onstatus("NetStream.Publish.Start")
        elif cmd == "play":
            name = values[3] if len(values) > 3 else ""
            if not isinstance(name, str) or not name:
                raise ValueError("rtmp: play without a stream name")
            name = name.split("?")[0]
            self._send_control(MSG_USER_CONTROL,
                               struct.pack(">HI", UC_STREAM_BEGIN, 1))
            self.send_onstatus("NetStream.Play.Reset")
            self.send_onstatus("NetStream.Play.Start")
            self.playing = name
            self.service.on_play(name, self)
        elif cmd in ("deleteStream", "closeStream"):
            self.close()

    def close(self):
        self.service.drop(self)
        self.publishing = None
        self.playing = None


# -- the client side ---------------------------------------------------------

class _ClientWire:
    def __init__(self, conn):
        self.conn = conn

    def write(self, buf, id_wait=None):
        self.conn.sendall(buf.to_bytes())
        return 0

    def failed(self):
        return False


class RtmpClientSession(RtmpSession):
    """The chunk machinery in client mode: messages read are kept in
    ``inbox`` instead of being run as commands; the peer's SetChunkSize
    is honoured."""

    def __init__(self, conn):
        super().__init__(_ClientWire(conn), RtmpService())
        self.conn = conn
        self.state = self.ST_ESTABLISHED
        self.inbox: List[tuple] = []

    def _on_message(self, msg_type, stream_id, ts, payload):
        if msg_type == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
            self.in_chunk = struct.unpack(">I", payload[:4])[0]
            return
        self.inbox.append((msg_type, ts, payload))

    def feed(self, data: bytes):
        self.feed_bytes(data)

    def pump(self, want: int = 1, timeout: float = 5.0):
        """Read the socket until ``want`` messages are kept or
        ``timeout`` seconds passed."""
        self.conn.settimeout(0.2)
        deadline = time.monotonic() + timeout
        while len(self.inbox) < want and time.monotonic() < deadline:
            try:
                data = self.conn.recv(65536)
            except (TimeoutError, pysocket.timeout):
                continue
            if not data:
                break
            self.feed(data)
        return self.inbox

    def pump_until(self, pred, timeout: float = 5.0):
        """Read until ``pred(self)`` holds or ``timeout`` seconds passed;
        whatever the reads' sizes."""
        deadline = time.monotonic() + timeout
        while not pred(self) and time.monotonic() < deadline:
            self.pump(want=len(self.inbox) + 1, timeout=0.3)
        return pred(self)

    def commands(self):
        return [amf.decode_all(p) for t, _, p in self.inbox
                if t == MSG_COMMAND_AMF0]


def rtmp_client_connect(host: str, port: int, app: str = "live"):
    """Dial, make the simple handshake and connect; returns (socket,
    RtmpClientSession) ready for createStream, publish or play."""
    conn = pysocket.create_connection((host, port), timeout=5)
    c1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
    conn.sendall(bytes([3]) + c1)
    buf = b""
    while len(buf) < 1 + 2 * HANDSHAKE_SIZE:
        chunk = conn.recv(65536)
        if not chunk:
            raise ConnectionError("rtmp: server hung up in handshake")
        buf += chunk
    if buf[0] != 3 or buf[1 + HANDSHAKE_SIZE:1 + 2 * HANDSHAKE_SIZE] != c1:
        raise ConnectionError("rtmp: bad handshake reply")
    conn.sendall(buf[1:1 + HANDSHAKE_SIZE])  # C2 echoes S1
    sess = RtmpClientSession(conn)
    sess.feed(buf[1 + 2 * HANDSHAKE_SIZE:])
    sess.send_command("connect", 1.0, {"app": app, "flashVer": "brpc_tpu"})
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if any(c and c[0] == "_result" for c in sess.commands()):
            break
        sess.pump(want=len(sess.inbox) + 1, timeout=0.5)
    results = [c for c in sess.commands() if c[0] == "_result"]
    if not results or results[0][3].get("code") != \
            "NetConnection.Connect.Success":
        raise ConnectionError("rtmp: connect refused")
    sess.inbox.clear()
    # chunk sizes are per direction: announce ours before large sends
    sess._send_control(MSG_SET_CHUNK_SIZE, struct.pack(">I", OUT_CHUNK))
    return conn, sess


# -- registration ------------------------------------------------------------

def _end_session(sess: RtmpSession):
    """The connection failed: the session leaves its relay."""
    sess.close()
    _rtmp_sessions.update(-1)


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    service = getattr(getattr(arg, "options", None), "rtmp_service", None)
    if service is None:
        return ParseResult.try_others()
    sess: Optional[RtmpSession] = getattr(sock, "rtmp_session", None)
    if sess is None:
        if len(portal) < 1:
            return ParseResult.not_enough()
        if portal.copy_to_bytes(1)[0] != 3:
            return ParseResult.try_others()
        # RTMP speaks first, with exactly 0x03: the connection is ours
        sess = sock.rtmp_session = RtmpSession(sock, service)
        _rtmp_sessions.update(1)
        sock.on_protocol_failed = lambda: _end_session(sess)
    # each byte moves once from the portal into the session
    n = len(portal)
    for view in portal.iter_views():
        sess.pending += view
    portal.pop_front(n)
    try:
        progressed = sess.feed_bytes(b"")
    except ValueError:
        sess.close()
        return ParseResult.error_()
    if not progressed:
        return ParseResult.not_enough()
    return ParseResult.ok(RtmpMessage())


register_protocol(Protocol(
    name="rtmp",
    type=ProtocolType.RTMP,
    parse=parse,
    process_request=None,  # the conversation runs inside parse
    process_response=None,
    process_inline=True,
))
