"""HTTP/1.x messages and their incremental parser.

Port of brpc_tpu/rpc/http_message.py, byte-compatible with it: requests
and responses with a case-insensitive header map, ``serialize`` to an
IOBuf, and ``try_parse``, which cuts one message off the front of a
portal when it is whole (``Content-Length`` or chunked bodies) and
answers "ok", "more", "not_http" or "error".

Faults of the reference not copied (ROADMAP queue C #15): it reads a
body only from the first 64 KiB of the portal, so a longer body comes out
cut short (``Content-Length``) or never completes (chunked), and it
raises on a head whose Content-Length or status code is not a number.
The port reads the whole body and answers "error" for such a head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple
from urllib.parse import unquote_plus

from brpc_tpu_torch.butil.iobuf import IOBuf

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 512 * 1024 * 1024

_METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ",
            b"PATCH ", b"TRACE ", b"CONNECT ")


class HttpHeader:
    """Case-insensitive header map; keys are kept lower-case."""

    def __init__(self):
        self._headers: Dict[str, str] = {}

    def set(self, key: str, value):
        self._headers[key.lower()] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._headers.get(key.lower(), default)

    def remove(self, key: str):
        self._headers.pop(key.lower(), None)

    def items(self):
        return self._headers.items()

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._headers

    def __len__(self):
        return len(self._headers)


class HttpRequest:
    def __init__(self, method: str = "GET", uri: str = "/"):
        self.method = method
        self.uri = uri
        self.version = "HTTP/1.1"
        self.headers = HttpHeader()
        self.body = IOBuf()

    @property
    def path(self) -> str:
        return self.uri.split("?", 1)[0]

    @property
    def query(self) -> Dict[str, str]:
        if "?" not in self.uri:
            return {}
        out = {}
        for pair in self.uri.split("?", 1)[1].split("&"):
            k, _, v = pair.partition("=")
            if k:
                out[unquote_plus(k)] = unquote_plus(v)
        return out

    def serialize(self) -> IOBuf:
        out = IOBuf()
        body_len = len(self.body)
        lines = [f"{self.method} {self.uri} {self.version}"]
        if "content-length" not in self.headers and (
                body_len or self.method in ("POST", "PUT", "PATCH")):
            self.headers.set("content-length", body_len)
        lines.extend(f"{k}: {v}" for k, v in self.headers.items())
        out.append(("\r\n".join(lines) + "\r\n\r\n").encode())
        if body_len:
            out.append(self.body)
        return out


class HttpResponse:
    def __init__(self, status_code: int = 200, reason: str = "OK"):
        self.status_code = status_code
        self.reason = reason
        self.version = "HTTP/1.1"
        self.headers = HttpHeader()
        self.body = IOBuf()

    def set_body(self, data, content_type: str = "text/plain"):
        self.body = data if isinstance(data, IOBuf) else IOBuf(data)
        self.headers.set("content-type", content_type)

    def serialize(self) -> IOBuf:
        out = IOBuf()
        self.headers.set("content-length", len(self.body))
        lines = [f"{self.version} {self.status_code} {self.reason}"]
        lines.extend(f"{k}: {v}" for k, v in self.headers.items())
        out.append(("\r\n".join(lines) + "\r\n\r\n").encode())
        if len(self.body):
            out.append(self.body)
        return out


def looks_like_http(head: bytes) -> bool:
    """True when ``head`` begins a status line or a request line (or is a
    prefix of one)."""
    if head.startswith(b"HTTP/1."):
        return True
    return any(head.startswith(m[: len(head)]) if len(head) < len(m)
               else head.startswith(m) for m in _METHODS)


def try_parse(portal: IOBuf) -> Tuple[str, Optional[object]]:
    """(state, message) with state "ok", "more", "not_http" or "error";
    on "ok" the message's bytes are cut off the portal."""
    n = len(portal)
    head = bytes(portal.copy_to_bytes(min(8, n)))
    if not looks_like_http(head):
        return "not_http", None
    scan = bytes(portal.copy_to_bytes(min(n, MAX_HEADER_BYTES)))
    idx = scan.find(b"\r\n\r\n")
    if idx < 0:
        if n >= MAX_HEADER_BYTES:
            return "error", None
        return "more", None
    body_start = idx + 4
    try:
        lines = scan[:idx].decode("latin-1").split("\r\n")
        first = lines[0]
        headers = HttpHeader()
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers.set(k.strip(), v.strip())
        content_length = int(headers.get("content-length", "0") or 0)
    except Exception:
        return "error", None
    if content_length > MAX_BODY_BYTES:
        return "error", None

    if headers.get("transfer-encoding", "").lower() == "chunked":
        parsed = _parse_chunked(bytes(portal.copy_to_bytes(n))[body_start:])
        if parsed is None:
            return "more", None
        body_bytes, consumed = parsed
        total = body_start + consumed
    else:
        total = body_start + content_length
        if n < total:
            return "more", None
        body_bytes = bytes(portal.copy_to_bytes(content_length, body_start))

    if first.startswith("HTTP/1."):
        parts = first.split(" ", 2)
        try:
            msg = HttpResponse(int(parts[1]),
                               parts[2] if len(parts) > 2 else "")
        except (IndexError, ValueError):
            return "error", None
        msg.version = parts[0]
    else:
        parts = first.split(" ")
        if len(parts) < 3:
            return "error", None
        msg = HttpRequest(parts[0], parts[1])
        msg.version = parts[2]
    msg.headers = headers
    msg.body = IOBuf(body_bytes)
    portal.pop_front(total)
    return "ok", msg


def _parse_chunked(data: bytes):
    """(body, bytes consumed), or None while incomplete."""
    body = bytearray()
    pos = 0
    while True:
        nl = data.find(b"\r\n", pos)
        if nl < 0:
            return None
        try:
            size = int(data[pos:nl].split(b";")[0], 16)
        except ValueError:
            return None
        chunk_start = nl + 2
        if size == 0:
            end = data.find(b"\r\n", chunk_start)
            if end < 0:
                return None
            return bytes(body), end + 2
        if len(data) < chunk_start + size + 2:
            return None
        body += data[chunk_start: chunk_start + size]
        pos = chunk_start + size + 2
