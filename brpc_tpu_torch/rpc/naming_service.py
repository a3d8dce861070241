"""NamingService — pushes server lists to the load balancer.

Port of brpc_tpu/rpc/naming_service.py, scheme for scheme:
  list://host:port[ w-or-tag],...         — a static list
  file:///path                            — a server file, re-read every 2 s
  dns://host:port (and http://)           — re-resolved every 5 s
  consul://, discovery://, nacos://,
  remotefile://host:port/path             — HTTP-polled registries, 2 s

``NamingServiceThread`` diffs each resolution against the last: a new
node gets an unconnected client socket (the channel dials it on first
use, after attaching the device handshake when the channel carries
tensors) and joins the balancer; a removed node leaves it and its socket
is recycled. The first resolution runs inside ``init``. Unlike the
reference, ``stop`` also recycles the sockets it created, so a closed
channel leaves no connection open.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.bthread import timer_add
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.rpc.socket import Socket

# (endpoint, weight, tag)
NodeSpec = Tuple[EndPoint, int, str]


class NamingService:
    """One resolution strategy. refresh_interval_s <= 0 means static."""

    name = "base"
    refresh_interval_s: float = 5.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        raise NotImplementedError


class ListNamingService(NamingService):
    name = "list"
    refresh_interval_s = -1.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        out = []
        for part in service_path.split(","):
            part = part.strip()
            if not part:
                continue
            weight, tag = 1, ""
            if " " in part:
                part, _, tag = part.partition(" ")
                tag = tag.strip()
                if tag.isdigit():
                    weight, tag = int(tag), ""
            out.append((EndPoint.parse(part), weight, tag))
        return out


def _parse_server_lines(text: str) -> List[NodeSpec]:
    """The server-list file grammar shared by file:// and remotefile://
    (policy/file_naming_service.cpp): 'ip:port[ weight-or-tag]' per line,
    '#' comments."""
    out: List[NodeSpec] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        weight, tag = 1, ""
        if " " in line:
            line, _, tag = line.partition(" ")
            tag = tag.strip()
            if tag.isdigit():
                weight, tag = int(tag), ""
        try:
            out.append((EndPoint.parse(line), weight, tag))
        except ValueError:
            continue
    return out


class FileNamingService(NamingService):
    name = "file"
    refresh_interval_s = 2.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        try:
            with open(service_path) as f:
                text = f.read()
        except OSError:
            return []
        return _parse_server_lines(text)


class DnsNamingService(NamingService):
    name = "dns"
    refresh_interval_s = 5.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        import socket as pysocket

        host, _, port_s = service_path.partition(":")
        port = int(port_s or 80)
        out = []
        try:
            infos = pysocket.getaddrinfo(host, port, pysocket.AF_INET,
                                         pysocket.SOCK_STREAM)
        except OSError:
            return out
        seen = set()
        for _, _, _, _, sockaddr in infos:
            ep = EndPoint(sockaddr[0], sockaddr[1])
            if ep not in seen:
                seen.add(ep)
                out.append((ep, 1, ""))
        return out


def _http_get_json(authority: str, path: str, timeout_s: float = 3.0):
    """GET http://authority/path -> parsed JSON (None on any failure).
    The HTTP-backed naming services (consul/discovery/nacos/remotefile)
    poll registry endpoints this way."""
    import json
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{authority}{path}",
                                    timeout=timeout_s) as r:
            return json.loads(r.read().decode())
    except Exception:
        return None


class ConsulNamingService(NamingService):
    """consul://host:port/service-name — polls Consul's health endpoint
    (policy/consul_naming_service.cpp: /v1/health/service/<name> with
    passing+stale, addresses from Service.Address/Port, tags kept)."""

    name = "consul"
    refresh_interval_s = 2.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        authority, _, service = service_path.partition("/")
        data = _http_get_json(
            authority, f"/v1/health/service/{service}?stale&passing")
        out: List[NodeSpec] = []
        if not isinstance(data, list):
            return out
        for entry in data:
            try:
                svc = entry["Service"]
                ep = EndPoint(svc["Address"], int(svc["Port"]))
                tags = svc.get("Tags") or []
                out.append((ep, 1, tags[0] if tags else ""))
            except (KeyError, TypeError, ValueError):
                continue
        return out


class DiscoveryNamingService(NamingService):
    """discovery://host:port/appid — the bilibili discovery shape
    (policy/discovery_naming_service.cpp): /discovery/fetchs returns
    zone->instances with addrs like 'grpc://ip:port'."""

    name = "discovery"
    refresh_interval_s = 2.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        authority, _, appid = service_path.partition("/")
        data = _http_get_json(
            authority, f"/discovery/fetchs?appid={appid}&status=1")
        out: List[NodeSpec] = []
        try:
            instances = data["data"][appid]["instances"]
        except (KeyError, TypeError):
            return out
        for inst in instances:
            for addr in inst.get("addrs", []):
                _, _, hostport = addr.rpartition("://")
                try:
                    out.append((EndPoint.parse(hostport), 1, ""))
                except ValueError:
                    continue
        return out


class NacosNamingService(NamingService):
    """nacos://host:port/serviceName — polls the Nacos instance list
    (policy/nacos_naming_service.cpp: /nacos/v1/ns/instance/list, healthy
    hosts with ip/port/weight)."""

    name = "nacos"
    refresh_interval_s = 2.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        authority, _, service = service_path.partition("/")
        data = _http_get_json(
            authority,
            f"/nacos/v1/ns/instance/list?serviceName={service}&healthyOnly=true")
        out: List[NodeSpec] = []
        if not isinstance(data, dict):
            return out
        for host in data.get("hosts", []):
            try:
                if not host.get("enabled", True):
                    continue
                out.append((EndPoint(host["ip"], int(host["port"])),
                            max(1, int(float(host.get("weight", 1)))), ""))
            except (KeyError, TypeError, ValueError):
                continue
        return out


class RemoteFileNamingService(NamingService):
    """remotefile://host:port/path — fetches a server-list file over HTTP
    and parses it with the file NS grammar
    (policy/remotefile_naming_service.cpp)."""

    name = "remotefile"
    refresh_interval_s = 2.0

    def get_servers(self, service_path: str) -> List[NodeSpec]:
        import urllib.request

        authority, _, path = service_path.partition("/")
        try:
            with urllib.request.urlopen(f"http://{authority}/{path}",
                                        timeout=3.0) as r:
                text = r.read().decode()
        except Exception:
            return []
        return _parse_server_lines(text)


_ns_registry: Dict[str, Callable[[], NamingService]] = {
    "list": ListNamingService,
    "file": FileNamingService,
    "dns": DnsNamingService,
    "http": DnsNamingService,
    "consul": ConsulNamingService,
    "discovery": DiscoveryNamingService,
    "nacos": NacosNamingService,
    "remotefile": RemoteFileNamingService,
}


class NamingServiceThread:
    """Owns the NS → LB flow: resolves periodically, diffs the node set,
    creates/destroys client Sockets, updates the LB
    (details/naming_service_thread.{h,cpp})."""

    def __init__(self, ns: NamingService, service_path: str, lb,
                 channel_options=None,
                 node_filter: Optional[Callable[[NodeSpec], bool]] = None):
        self._ns = ns
        self._path = service_path
        self._lb = lb
        self._options = channel_options
        self._filter = node_filter
        self._sockets: Dict[EndPoint, int] = {}  # endpoint -> sid
        self._lock = threading.Lock()
        self._stopped = False
        self.refresh()  # first resolution is synchronous (blocking init)
        if ns.refresh_interval_s > 0:
            timer_add(ns.refresh_interval_s, self._periodic)

    def _periodic(self):
        if self._stopped:
            return
        try:
            self.refresh()
        finally:
            if not self._stopped:
                timer_add(self._ns.refresh_interval_s, self._periodic)

    def refresh(self):
        nodes = self._ns.get_servers(self._path)
        if self._filter is not None:
            nodes = [n for n in nodes if self._filter(n)]
        hc = (self._options.health_check_interval_s
              if self._options is not None else -1)
        new_eps = {}
        for ep, weight, tag in nodes:
            new_eps[ep] = (weight, tag)
        with self._lock:
            if self._stopped:
                return
            for ep, (weight, tag) in new_eps.items():
                if ep not in self._sockets:
                    sid = Socket.create(remote_side=ep,
                                        health_check_interval_s=hc)
                    self._sockets[ep] = sid
                    self._lb.add_server(sid, weight, tag)
            for ep in [e for e in self._sockets if e not in new_eps]:
                sid = self._sockets.pop(ep)
                self._lb.remove_server(sid)
                s = Socket.address(sid)
                if s is not None:
                    s.recycle()

    def stop(self):
        """No more refreshes; recycle every socket this thread made."""
        with self._lock:
            self._stopped = True
            sids, self._sockets = list(self._sockets.values()), {}
        for sid in sids:
            self._lb.remove_server(sid)
            s = Socket.address(sid)
            if s is not None:
                s.recycle()


def start_naming_service(url: str, lb, channel_options=None,
                         node_filter=None) -> Optional[NamingServiceThread]:
    """Parse scheme://path, build the NS, start its thread."""
    scheme, sep, path = url.partition("://")
    if not sep:
        return None
    factory = _ns_registry.get(scheme)
    if factory is None:
        return None
    return NamingServiceThread(factory(), path, lb, channel_options,
                               node_filter)
