"""RTMP client — connect, createStream, play and publish over the digest
handshake, and the edge pull.

Port of brpc_tpu/rpc/rtmp_client.py, with its wire bytes: C1 carries an
HMAC-SHA256 digest keyed by the Flash Player key (``FP_KEY``) at an
offset its bytes give (two schemes); the server proves itself with the
Media Server key (``FMS_KEY``), and C2 and S2 are HMACs chained from the
peer's digest. A server without the digest gets the simple handshake.
The keys and the layout are the public RTMP handshake's constants.

``RtmpClient`` drives rpc/rtmp_protocol.py's ``RtmpClientSession``; its
reader is a thread (``start_reader``) that hands audio, video and data
messages to each stream's sink and keeps the commands in a bounded
log. Every wait has a deadline. ``RtmpClientStream`` publishes
(``publish``, ``send_metadata``, ``send_audio``, ``send_video``) or
plays. ``pull_into_service`` is the edge pull: a server's client plays
a stream from another server and republishes it into its own
``RtmpService``.

One repair of the reference (ROADMAP queue C): the pull's stand-in
publisher reports failure once the pull's connection has ended, and the
edge drops it then, so a dead pull frees its name; in the reference the
name stays claimed until the process ends.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import socket as pysocket
import struct
import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch.rpc import amf
from brpc_tpu_torch.rpc import rtmp_protocol as rp
from brpc_tpu_torch.rpc.rtmp_protocol import (
    HANDSHAKE_SIZE,
    MSG_AUDIO,
    MSG_COMMAND_AMF0,
    MSG_DATA_AMF0,
    MSG_SET_CHUNK_SIZE,
    MSG_VIDEO,
    OUT_CHUNK,
    RtmpClientSession,
)

# RTMP digest handshake constants (public protocol constants)
FP_KEY = b"Genuine Adobe Flash Player 001"          # 30 bytes
FMS_KEY = b"Genuine Adobe Flash Media Server 001"   # 36 bytes
_CRUD = bytes([
    0xF0, 0xEE, 0xC2, 0x4A, 0x80, 0x68, 0xBE, 0xE8,
    0x2E, 0x00, 0xD0, 0xD1, 0x02, 0x9E, 0x7E, 0x57,
    0x6E, 0xEC, 0x5D, 0x2D, 0x29, 0x80, 0x6F, 0xAB,
    0x93, 0xB8, 0xE6, 0x36, 0xCF, 0xEB, 0x31, 0xAE,
])
FP_KEY_FULL = FP_KEY + _CRUD    # 62 bytes, keys C2
FMS_KEY_FULL = FMS_KEY + _CRUD  # 68 bytes, keys S2


def _digest_offset(block: bytes, scheme: int) -> int:
    if scheme == 0:
        return sum(block[8:12]) % 728 + 12
    return sum(block[772:776]) % 728 + 776


def _with_digest(block: bytearray, scheme: int, key: bytes) -> bytes:
    off = _digest_offset(block, scheme)
    joined = bytes(block[:off]) + bytes(block[off + 32:])
    dig = hmac.new(key, joined, hashlib.sha256).digest()
    block[off:off + 32] = dig
    return dig


def find_digest(block: bytes, key: bytes) -> Optional[tuple]:
    """Returns (scheme, digest) when `block` carries a valid digest."""
    for scheme in (0, 1):
        off = _digest_offset(block, scheme)
        if off + 32 > len(block):
            continue
        joined = block[:off] + block[off + 32:]
        dig = hmac.new(key, joined, hashlib.sha256).digest()
        if hmac.compare_digest(dig, block[off:off + 32]):
            return scheme, dig
    return None


def make_digest_c1() -> tuple:
    """(c1_bytes, digest): time + nonzero version + digested random."""
    c1 = bytearray(struct.pack(">I", int(time.time()) & 0xFFFFFFFF)
                   + b"\x80\x00\x07\x02"
                   + os.urandom(HANDSHAKE_SIZE - 8))
    dig = _with_digest(c1, 0, FP_KEY)
    return bytes(c1), dig


def make_digest_s1(scheme: int) -> tuple:
    s1 = bytearray(struct.pack(">I", int(time.time()) & 0xFFFFFFFF)
                   + b"\x04\x05\x00\x01"
                   + os.urandom(HANDSHAKE_SIZE - 8))
    dig = _with_digest(s1, scheme, FMS_KEY)
    return bytes(s1), dig


def make_chained_reply(peer_digest: bytes, key_full: bytes) -> bytes:
    """C2/S2 in digest mode: random body + HMAC keyed by
    HMAC(key_full, peer's digest)."""
    chain_key = hmac.new(key_full, peer_digest, hashlib.sha256).digest()
    body = bytearray(os.urandom(HANDSHAKE_SIZE))
    dig = hmac.new(chain_key, bytes(body[:-32]), hashlib.sha256).digest()
    body[-32:] = dig
    return bytes(body)


def verify_chained_reply(reply: bytes, own_digest: bytes,
                         key_full: bytes) -> bool:
    chain_key = hmac.new(key_full, own_digest, hashlib.sha256).digest()
    dig = hmac.new(chain_key, reply[:-32], hashlib.sha256).digest()
    return hmac.compare_digest(dig, reply[-32:])


class RtmpClientStream:
    """One created stream on a client connection: play or publish."""

    def __init__(self, client: "RtmpClient", stream_id: int):
        self.client = client
        self.stream_id = stream_id
        self.name: Optional[str] = None

    # -- publisher half -----------------------------------------------------
    def publish(self, name: str, timeout: float = 5.0):
        c = self.client
        since = c._cmd_marker()
        c.sess.send_command("releaseStream", c._txn(), None, name)
        c.sess.send_command("FCPublish", c._txn(), None, name)
        c.sess.send_command("publish", c._txn(), None, name, "live",
                            stream_id=self.stream_id, csid=4)
        if not c._wait_status("NetStream.Publish.Start", timeout,
                              since=since):
            raise ConnectionError(f"rtmp: publish {name!r} refused")
        self.name = name
        return self

    def send_metadata(self, meta: dict, ts: int = 0):
        payload = amf.encode_many("onMetaData", meta)
        self.client.sess.send_message(MSG_DATA_AMF0, ts, payload,
                                      stream_id=self.stream_id, csid=4)

    def send_audio(self, payload: bytes, ts: int):
        self.client.sess.send_message(MSG_AUDIO, ts, payload,
                                      stream_id=self.stream_id, csid=4)

    def send_video(self, payload: bytes, ts: int):
        self.client.sess.send_message(MSG_VIDEO, ts, payload,
                                      stream_id=self.stream_id, csid=4)

    # -- player half --------------------------------------------------------
    def play(self, name: str,
             on_media: Callable[[int, int, bytes], None],
             timeout: float = 5.0):
        """Start playing; on_media(msg_type, timestamp, payload) runs on
        the client's reader thread for every audio/video/data message."""
        c = self.client
        since = c._cmd_marker()
        c._media_sinks[self.stream_id] = on_media
        c.sess.send_command("play", c._txn(), None, name,
                            stream_id=self.stream_id, csid=4)
        if not c._wait_status("NetStream.Play.Start", timeout,
                              since=since):
            c._media_sinks.pop(self.stream_id, None)
            raise ConnectionError(f"rtmp: play {name!r} refused")
        self.name = name
        return self


class RtmpClient:
    """A client connection: the digest handshake (the simple one as a
    fallback), connect, createStream, then play or publish."""

    def __init__(self, host: str, port: int, app: str = "live",
                 use_digest: bool = True, timeout: float = 5.0):
        self.host, self.port, self.app = host, port, app
        self.use_digest = use_digest
        self.timeout = timeout
        self.conn = None
        self.sess: Optional[RtmpClientSession] = None
        self.digest_mode = False
        self._txn_id = 1.0
        self._media_sinks = {}
        self._reader: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # set when the reader has stopped (the peer hung up, a protocol
        # error, or close); ``_on_end`` callables run then, once
        self._ended = threading.Event()
        self._on_end: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        # commands the reader thread pulled out of the session inbox,
        # decoded once, bounded, tagged with a monotone seq so waiters
        # only match commands that arrived after they started caring
        # (a stale NetStream.Play.Start from stream A must not approve
        # a later, refused play on stream B)
        self._cmd_log: List[tuple] = []  # (seq, decoded command)
        self._cmd_seq = 0

    def _txn(self) -> float:
        self._txn_id += 1.0
        return self._txn_id

    # -- handshake ----------------------------------------------------------
    def _handshake(self):
        conn = pysocket.create_connection((self.host, self.port),
                                          timeout=self.timeout)
        if self.use_digest:
            c1, c1_digest = make_digest_c1()
        else:
            c1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
            c1_digest = b""
        conn.sendall(bytes([3]) + c1)
        buf = b""
        while len(buf) < 1 + 2 * HANDSHAKE_SIZE:
            chunk = conn.recv(65536)
            if not chunk:
                raise ConnectionError("rtmp: server hung up in handshake")
            buf += chunk
        if buf[0] != 3:
            raise ConnectionError("rtmp: bad handshake version")
        s1 = buf[1:1 + HANDSHAKE_SIZE]
        s2 = buf[1 + HANDSHAKE_SIZE:1 + 2 * HANDSHAKE_SIZE]
        found = find_digest(s1, FMS_KEY) if self.use_digest else None
        if found is not None:
            # digest mode: the server proved itself with the FMS key;
            # optionally S2 chains from OUR digest — verify when shaped so
            _, s1_digest = found
            self.digest_mode = True
            if c1_digest and not (
                    s2 == c1 or
                    verify_chained_reply(s2, c1_digest, FMS_KEY_FULL)):
                raise ConnectionError("rtmp: S2 fails digest verification")
            conn.sendall(make_chained_reply(s1_digest, FP_KEY_FULL))
        else:
            # simple mode (pre-digest server): S2 must echo C1; C2 echoes S1
            if s2 != c1:
                raise ConnectionError("rtmp: bad simple-handshake reply")
            conn.sendall(s1)
        self.conn = conn
        leftover = buf[1 + 2 * HANDSHAKE_SIZE:]
        self.sess = RtmpClientSession(conn)
        if leftover:
            self.sess.feed(leftover)

    # -- connection ---------------------------------------------------------
    def connect(self) -> "RtmpClient":
        self._handshake()
        self.sess.send_command("connect", 1.0,
                               {"app": self.app, "flashVer": "brpc_tpu",
                                "tcUrl": f"rtmp://{self.host}:{self.port}/"
                                         f"{self.app}"})
        ok = self.sess.pump_until(
            lambda s: any(c and c[0] == "_result" and len(c) > 3
                          and isinstance(c[3], dict)
                          and c[3].get("code") ==
                          "NetConnection.Connect.Success"
                          for c in s.commands()),
            timeout=self.timeout)
        if not ok:
            raise ConnectionError("rtmp: connect refused")
        self.sess.inbox.clear()
        self.sess._send_control(MSG_SET_CHUNK_SIZE,
                                struct.pack(">I", OUT_CHUNK))
        return self

    def _cmd_marker(self) -> int:
        """Watermark for _wait_command: take BEFORE sending the command
        whose reply is awaited (the reply may be logged between the send
        and the wait)."""
        with self._lock:
            return self._cmd_seq

    def _wait_command(self, pred, timeout: float, since: int = 0):
        """Wait for a command matching pred. Commands may arrive via the
        reader thread (drained once into _cmd_log) or be pumped here when
        no reader is running — never both recv'ing concurrently. Only
        log entries newer than `since` count."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                cmds = self.sess.commands() + [
                    c for q, c in self._cmd_log if q > since]
            for c in cmds:
                if c and pred(c):
                    return c
            if self._reader is None:
                self.sess.pump(want=len(self.sess.inbox) + 1, timeout=0.3)
            else:
                time.sleep(0.02)
        return None

    def create_stream(self, timeout: float = 5.0) -> RtmpClientStream:
        txn = self._txn()
        since = self._cmd_marker()
        self.sess.send_command("createStream", txn, None)
        c = self._wait_command(
            lambda c: c[0] == "_result" and len(c) > 1 and c[1] == txn,
            timeout, since=since)
        if c is None:
            raise ConnectionError("rtmp: createStream timed out")
        sid = int(c[3]) if len(c) > 3 and isinstance(c[3], (int, float)) \
            else 1
        with self._lock:
            if self._reader is None:
                self.sess.inbox.clear()
        return RtmpClientStream(self, sid)

    def _wait_status(self, code: str, timeout: float,
                     since: int = 0) -> bool:
        return self._wait_command(
            lambda c: c[0] == "onStatus" and len(c) > 3 and
            isinstance(c[3], dict) and c[3].get("code") == code,
            timeout, since=since) is not None

    # -- reader thread (player mode) ----------------------------------------
    def start_reader(self):
        """Hand the media read to each stream's sink, on a thread."""
        if self._reader is not None:
            return

        def run():
            self.conn.settimeout(0.2)
            while not self._stop.is_set():
                try:
                    data = self.conn.recv(65536)
                except (TimeoutError, pysocket.timeout):
                    self._drain_media()
                    continue
                except OSError:
                    break
                if not data:
                    break
                try:
                    with self._lock:
                        self.sess.feed(data)
                except ValueError:
                    break
                self._drain_media()
            self._drain_media()
            self._end()

        self._reader = threading.Thread(target=run, daemon=True,
                                        name="rtmp_client_reader")
        self._reader.start()

    def _drain_media(self):
        with self._lock:
            items, self.sess.inbox[:] = list(self.sess.inbox), []
        for msg_type, ts, payload in items:
            if msg_type in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
                for sink in list(self._media_sinks.values()):
                    try:
                        sink(msg_type, ts, payload)
                    except Exception:
                        pass
            elif msg_type == MSG_COMMAND_AMF0:
                # consumed once into the bounded command log (re-appending
                # to inbox would re-scan them forever and leak); decode
                # here so waiters polling the log never re-decode
                try:
                    decoded = amf.decode_all(payload)
                except amf.AmfError:
                    continue
                with self._lock:
                    self._cmd_seq += 1
                    self._cmd_log.append((self._cmd_seq, decoded))
                    del self._cmd_log[:-64]

    def _end(self):
        self._ended.set()
        with self._lock:
            hooks, self._on_end = self._on_end, []
        for hook in hooks:
            hook()

    def ended(self) -> bool:
        """True once the reader stopped or the client closed."""
        return self._ended.is_set()

    def close(self):
        self._stop.set()
        if self._reader is not None:
            self._reader.join(timeout=2)
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self._end()


def pull_into_service(service: "rp.RtmpService", name: str, host: str,
                      port: int, app: str = "live",
                      remote_name: Optional[str] = None,
                      timeout: float = 5.0) -> RtmpClient:
    """The edge pull: this server's client plays ``remote_name`` (default
    ``name``) from host:port and republishes it into ``service`` under
    ``name``, so this server's players read a stream published
    elsewhere. The name is held while the pull's connection lives."""

    class _PullOrigin:
        """The stand-in publisher session; its ``sock`` reports failure
        once the pull has ended."""

        def __init__(self):
            self.client: Optional[RtmpClient] = None
            self.sock = self

        def failed(self) -> bool:
            return self.client is not None and self.client.ended()

    origin = _PullOrigin()
    if not service.on_publish(name, origin):
        raise RuntimeError(f"rtmp relay: stream {name!r} already "
                           f"has a publisher")
    client = RtmpClient(host, port, app=app, timeout=timeout)
    origin.client = client
    try:
        client.connect()
        stream = client.create_stream()

        def on_media(msg_type, ts, payload):
            service.on_media(name, msg_type, ts, payload)

        client._on_end.append(lambda: service.drop(origin))
        client.start_reader()
        stream.play(remote_name or name, on_media, timeout=timeout)
    except Exception:
        # release the claim, or the name stays held
        service.release_publisher(name, origin)
        client.close()
        raise
    return client
