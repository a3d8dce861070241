"""EndPoint — the address of a peer.

Copy of brpc_tpu/butil/endpoint.py: an (ip, port) value type with the
reference's optional device coordinate suffix (``ip:port/tpu:p.s.c.r``),
kept so that both packages parse the same naming-service texts into the
same nodes and reject the same garbage. The port itself never sets a
coordinate; it only carries one through.
"""
from __future__ import annotations

import re
import socket
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True, order=True)
class DeviceCoord:
    """A coordinate suffix as the reference writes it: (pod, slice, chip,
    core)."""

    pod: int = 0
    slice: int = 0
    chip: int = 0
    core: int = 0

    def __str__(self) -> str:
        return f"tpu:{self.pod}.{self.slice}.{self.chip}.{self.core}"


_ENDPOINT_RE = re.compile(
    r"^(?P<host>[^:]+|\[[0-9a-fA-F:]+\]):(?P<port>\d+)"
    r"(?:/tpu:(?P<pod>\d+)\.(?P<slc>\d+)\.(?P<chip>\d+)\.(?P<core>\d+))?$"
)


@dataclass(frozen=True, order=True)
class EndPoint:
    ip: str = "0.0.0.0"
    port: int = 0
    device: Optional[DeviceCoord] = field(default=None, compare=False)

    @classmethod
    def parse(cls, text: str) -> "EndPoint":
        """Parse 'ip:port' or 'ip:port/tpu:p.s.c.r'; ValueError otherwise."""
        m = _ENDPOINT_RE.match(str(text).strip())
        if not m:
            raise ValueError(f"invalid endpoint: {text!r}")
        host = m.group("host").strip("[]")
        port = int(m.group("port"))
        if not 0 <= port <= 65535:
            raise ValueError(f"port out of range: {port}")
        dev = None
        if m.group("pod") is not None:
            dev = DeviceCoord(int(m.group("pod")), int(m.group("slc")),
                              int(m.group("chip")), int(m.group("core")))
        return cls(host, port, dev)

    def resolve(self) -> "EndPoint":
        """A hostname resolved to an IPv4 address."""
        try:
            socket.inet_aton(self.ip)
            return self
        except OSError:
            return EndPoint(socket.gethostbyname(self.ip), self.port,
                            self.device)

    def as_sockaddr(self) -> Tuple[str, int]:
        return (self.ip, self.port)

    def __str__(self) -> str:
        host = f"[{self.ip}]" if ":" in self.ip else self.ip
        base = f"{host}:{self.port}"
        if self.device is not None:
            return f"{base}/{self.device}"
        return base
