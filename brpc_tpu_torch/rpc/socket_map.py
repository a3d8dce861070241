"""SocketMap — client connections shared by every channel of the process.

Port of brpc_tpu/rpc/socket_map.py: a "single" connection is shared by
all channels with the same key and counted by reference; ``remove``
drops a reference and recycles the socket at zero. The key is the
endpoint plus the channel's signature: its protocol, TLS or not, its
authenticator and the app-level connect identity ("device" for channels
that carry tensors). Channels that share a device connection share its
DeviceEndpoint: one handshake per socket.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.rpc.socket import Socket

# (ip, port, protocol, ssl, auth_id, app_connect_id)
SocketMapKey = Tuple[str, int, str, bool, int, str]


def make_key(ep: EndPoint, protocol: str = "tpu_std", ssl: bool = False,
             auth=None, app_connect_id: str = "") -> SocketMapKey:
    return (ep.ip, ep.port, protocol, bool(ssl),
            id(auth) if auth is not None else 0, app_connect_id)


class _Entry:
    __slots__ = ("sid", "refcount")

    def __init__(self, sid: int):
        self.sid = sid
        self.refcount = 0


class SocketMap:
    def __init__(self):
        self._map: Dict[SocketMapKey, _Entry] = {}
        self._lock = threading.Lock()

    def insert(self, ep: EndPoint, key: SocketMapKey,
               health_check_interval_s: float = -1,
               app_connect_factory: Optional[Callable] = None,
               ssl_context=None) -> int:
        """The shared socket id of ``key``, made (unconnected) when there
        is none or the one there failed or is draining; one more
        reference either way. ``app_connect_factory`` makes the new
        socket's connect hook (a DeviceEndpoint of its own);
        ``ssl_context`` makes it dial through TLS."""
        with self._lock:
            entry = self._map.get(key)
            if entry is not None:
                sock = Socket.address(entry.sid)
                if sock is not None and sock.usable_for_new_calls():
                    entry.refcount += 1
                    return entry.sid
                # a failed or draining socket is replaced, not recycled:
                # its calls in flight still complete on it
                del self._map[key]
            from brpc_tpu_torch.rpc.channel import get_client_messenger

            sid = Socket.create(
                remote_side=ep,
                on_edge_triggered_events=get_client_messenger().on_new_messages,
                health_check_interval_s=health_check_interval_s,
                app_connect=(app_connect_factory()
                             if app_connect_factory is not None else None),
                ssl_context=ssl_context)
            entry = _Entry(sid)
            entry.refcount = 1
            self._map[key] = entry
            return sid

    def find(self, ep: Optional[EndPoint] = None,
             key: Optional[SocketMapKey] = None) -> Optional[int]:
        """The socket id shared under ``key`` (or ``make_key(ep)``), or
        None; takes no reference."""
        if key is None:
            if ep is None:
                raise ValueError("find() needs an endpoint or a key")
            key = make_key(ep)
        with self._lock:
            entry = self._map.get(key)
            return entry.sid if entry else None

    def count(self) -> int:
        """Keys with a shared socket."""
        with self._lock:
            return len(self._map)

    def remove(self, key: SocketMapKey, expected_sid: Optional[int] = None):
        """Drop one reference; recycle the socket at zero. With
        ``expected_sid``, only when that is still the key's socket."""
        with self._lock:
            entry = self._map.get(key)
            if entry is None:
                return
            if expected_sid is not None and entry.sid != expected_sid:
                return
            entry.refcount -= 1
            if entry.refcount > 0:
                return
            del self._map[key]
            sid = entry.sid
        sock = Socket.address(sid)
        if sock is not None:
            sock.recycle()


_global_map: Optional[SocketMap] = None
_global_lock = threading.Lock()


def get_global_socket_map() -> SocketMap:
    global _global_map
    if _global_map is None:
        with _global_lock:
            if _global_map is None:
                _global_map = SocketMap()
    return _global_map
