"""Builtin console — the HTTP debug pages every server carries.

Port of brpc_tpu/builtin/console.py, with its URLs and its text formats,
served by the HTTP protocol's router on the RPC port: ``/status``,
``/vars`` (``/vars/<name>``, ``?chart=1``), ``/flags`` (``?setvalue=``),
``/health``, ``/connections``, ``/index``, ``/version``,
``/brpc_metrics`` (Prometheus), ``/protobufs``, ``/bthreads``,
``/sockets``, ``/heap``, ``/growth``, ``/list``, ``/vlog``, ``/dir``,
``/ids``, ``/rpcz`` (``?trace_id=<hex>``, ``?limit=N``), ``/rpc_dump``,
and the profilers' ``/hotspots``, ``/pprof`` and ``/threads``
(builtin/hotspots.py). A handler takes (server, http_request) and
returns (status, content_type, body), or with extra headers a 4-tuple.

Each page prints what the port has. Left out: the native runtime's
sections of ``/status`` and ``/connections``, its ``/heap/native``
and ``/growth/native`` profiles and the capture window of
``/rpc_dump?seconds=N`` (not ported yet, ROADMAP A12b: those answer
the reference's "native runtime unavailable", and ``/rpc_dump`` shows
the reference's status page without a native recorder), and the page of
a module not ported yet: ``/fleet``.
"""
from __future__ import annotations

import json
import logging
import os
import stat
import time
from xml.sax.saxutils import escape

from brpc_tpu_torch import bvar, rpcz
from brpc_tpu_torch.builtin.hotspots import (
    _NATIVE_UNAVAILABLE,
    hotspots_handler,
    pprof_handler,
    threads_handler,
)
from brpc_tpu_torch.butil import flags as flags_mod
from brpc_tpu_torch.rpc import rpc_dump  # noqa: F401 (defines its flags)


def _version() -> str:
    import brpc_tpu_torch

    return f"brpc_tpu_torch/{brpc_tpu_torch.__version__}"


def _status_handler(server, req):
    """/status: the server and each method's stats."""
    lines = [
        f"version: {_version()}",
        "non-service: builtin",
        f"uptime: {time.time() - (server.start_time or time.time()):.0f}s",
        f"listen: {server.listen_endpoint}",
        f"connection_count: {server.connection_count()}",
        f"service_count: {server.service_count}",
        "",
    ]
    for _, st in sorted(server.method_statuses().items()):
        lines.append(st.describe())
    return 200, "text/plain", "\n".join(lines) + "\n"


def _vars_handler(server, req):
    """/vars: every exposed variable; /vars/<name> keeps the names that
    hold <name>; ?chart=1 draws a windowed variable's series as SVG."""
    parts = [p for p in req.path.split("/") if p]
    needle = parts[1] if len(parts) > 1 else None
    if needle and req.query.get("chart"):
        return _var_chart(needle, req)
    out = []
    for name, value in bvar.dump_exposed():
        if needle and needle not in name:
            continue
        if hasattr(value, "average"):
            value = f"avg={value.average:.3f} num={value.num}"
        out.append(f"{name} : {value}")
    return 200, "text/plain", "\n".join(out) + "\n"


def _var_chart(name: str, req):
    """An SVG line of a Window or PerSecond variable's per-second series;
    ?format=json gives the points."""
    var = bvar.find_exposed(name)
    if var is None:
        # a unique substring names a listed variable too
        matches = [n for n, _ in bvar.dump_exposed() if name in n]
        if len(matches) == 1:
            var = bvar.find_exposed(matches[0])
            name = matches[0]
    if var is None:
        return 404, "text/plain", f"no such var: {name}\n"
    series_fn = getattr(var, "series", None)
    if series_fn is None:
        return 400, "text/plain", f"{name} is not a windowed var\n"
    points = series_fn()
    if req.query.get("format") == "json":
        body = json.dumps({"var": name,
                           "points": [[round(t, 3), v] for t, v in points]})
        return 200, "application/json", body + "\n"
    w, h, pad = 480, 120, 6
    if len(points) < 2:
        svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
               f'height="{h}"><text x="10" y="20">{escape(name)}: '
               f'collecting samples...</text></svg>')
        return 200, "image/svg+xml", svg
    values = [v for _, v in points]
    vmin, vmax = min(values), max(values)
    spread = (vmax - vmin) or 1.0
    t0, t1 = points[0][0], points[-1][0]
    tspan = (t1 - t0) or 1.0
    coords = " ".join(
        f"{pad + (t - t0) / tspan * (w - 2 * pad):.1f},"
        f"{h - pad - (v - vmin) / spread * (h - 2 * pad):.1f}"
        for t, v in points)
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}">'
        f'<rect width="{w}" height="{h}" fill="#fcfcfc" stroke="#ccc"/>'
        f'<polyline points="{coords}" fill="none" stroke="#3366cc" '
        f'stroke-width="1.5"/>'
        f'<text x="8" y="14" font-size="11" fill="#333">{escape(name)} '
        f'(last {len(points)}s: min={vmin:.6g} max={vmax:.6g})</text>'
        f'</svg>')
    return 200, "image/svg+xml", svg


def _flags_handler(server, req):
    """/flags lists the flags; /flags/<name>?setvalue=v edits a reloadable
    one live."""
    parts = [p for p in req.path.split("/") if p]
    if len(parts) > 1:
        name = parts[1]
        setvalue = req.query.get("setvalue")
        if setvalue is not None:
            if flags_mod.set_flag(name, setvalue):
                return 200, "text/plain", f"{name} set to {setvalue}\n"
            return 403, "text/plain", f"cannot set {name}\n"
        try:
            f = flags_mod.flag(name)
        except KeyError:
            return 404, "text/plain", f"no such flag: {name}\n"
        return 200, "text/plain", (
            f"{f.name}={f.value} (default={f.default}) "
            f"{'[reloadable]' if f.reloadable else ''} {f.help}\n")
    out = []
    for name, f in sorted(flags_mod.all_flags().items()):
        mark = " (R)" if f.reloadable else ""
        out.append(f"{name}={f.value}{mark}  # {f.help}")
    return 200, "text/plain", "\n".join(out) + "\n"


def _health_handler(server, req):
    return 200, "text/plain", "OK\n"


def _connections_handler(server, req):
    """/connections: the server's connections."""
    lines = ["remote_side          |socket_id          |state"]
    for sock in server.list_connections():
        lines.append(
            f"{str(sock.remote_side):21s}|{sock.socket_id:<19d}|"
            f"{'failed' if sock.failed() else 'ok'}")
    return 200, "text/plain", "\n".join(lines) + "\n"


def _index_handler(server, req):
    pages = sorted(server._builtin_handlers.keys())
    methods = sorted(server.method_statuses().keys())
    body = ("brpc_tpu server console\n\npages:\n"
            + "\n".join(f"  /{p}" for p in pages)
            + "\n\nmethods:\n"
            + "\n".join(f"  /{m.replace('.', '/')}" for m in methods)
            + "\n")
    return 200, "text/plain", body


def _version_handler(server, req):
    return 200, "text/plain", f"{_version()}\n"


def _metrics_handler(server, req):
    """/brpc_metrics: the Prometheus text of every variable."""
    return 200, "text/plain; version=0.0.4", bvar.dump_prometheus()


def _protobufs_handler(server, req):
    """/protobufs: the messages the methods take and give, by proto full
    name and file."""
    seen = {}
    for _, minfo, _ in server._methods.values():
        for cls in (minfo.request_class, minfo.response_class):
            if getattr(cls, "FULL_NAME", ""):
                seen[cls.FULL_NAME] = cls.PROTO_FILE
            else:
                seen[cls.__name__] = "<python>"
    body = "\n".join(f"{k}  ({v})" for k, v in sorted(seen.items()))
    return 200, "text/plain", body + "\n"


def _bthreads_handler(server, req):
    """/bthreads: the task control's workers and queues."""
    from brpc_tpu_torch.bthread import get_task_control

    tc = get_task_control()
    lines = [
        f"workers: {len(tc.groups)}",
        f"queued: {tc._queued_count()}",
        f"switches: {tc._nswitch_var.get_value()}",
        f"finished: {tc._finished_var.get_value()}",
    ]
    for g in tc.groups:
        lines.append(
            f"  group {g.group_id}: rq={len(g._rq)} remote={len(g._remote_rq)}"
            f" bound={len(g._bound_rq)} nswitch={g.nswitch}")
    return 200, "text/plain", "\n".join(lines) + "\n"


def _sockets_handler(server, req):
    """/sockets: the socket id slots of the process."""
    from brpc_tpu_torch.rpc.socket import _registry

    return 200, "text/plain", f"socket_slots: {_registry.size()}\n"


def _native_or(profile, req):
    parts = [p for p in req.path.split("/") if p]
    if len(parts) > 1 and parts[1] == "native":
        return 200, "text/plain", _NATIVE_UNAVAILABLE
    return 200, "text/plain", profile()


def _heap_handler(server, req):
    """/heap: live allocations by site (tracemalloc)."""
    from brpc_tpu_torch.builtin import profilers

    return _native_or(profilers.heap_profile, req)


def _growth_handler(server, req):
    """/growth: allocation growth since profiling started (tracemalloc)."""
    from brpc_tpu_torch.builtin import profilers

    return _native_or(profilers.growth_profile, req)


def _rpcz_handler(server, req):
    """/rpcz: the newest spans; ?trace_id=<hex> one trace."""
    return 200, "text/plain", rpcz.describe_recent_spans(req.query)


def _rpc_dump_status_body():
    """/rpc_dump's status: the reference's page without a native
    recorder, and the flags of the recorder of the Python lane."""
    lines = ["traffic flight recorder (rpc_dump)", "",
             "native recorder: unavailable (no native runtime)", "",
             f"python lane: -rpc_dump={flags_mod.get_flag('rpc_dump')} "
             f"-rpc_dump_dir={flags_mod.get_flag('rpc_dump_dir')} "
             f"-rpc_dump_sample_every="
             f"{flags_mod.get_flag('rpc_dump_sample_every')}",
             "",
             "GET /rpc_dump?seconds=N[&every=M][&dir=PATH] arms a "
             "bounded native capture window; replay the files with "
             "`python tools/rpc_replay.py --native`."]
    return "\n".join(lines) + "\n"


def _rpc_dump_handler(server, req):
    """/rpc_dump: the recorder's status; a capture window (?seconds=N)
    needs the native runtime."""
    if req.query.get("seconds"):
        return 200, "text/plain", _NATIVE_UNAVAILABLE
    return 200, "text/plain", _rpc_dump_status_body()


def _list_handler(server, req):
    """/list: the services and their methods as JSON."""
    out = {}
    for (svc, method) in server._methods:
        out.setdefault(svc, []).append(method)
    return 200, "application/json", json.dumps(out, indent=1) + "\n"


def _vlog_handler(server, req):
    """/vlog: the loggers and their levels; ?setlevel=<logger>=<LEVEL>
    sets one."""
    setlevel = req.query.get("setlevel")
    if setlevel:
        name, sep, level = setlevel.partition("=")
        if not sep:
            return 400, "text/plain", "setlevel wants logger=LEVEL\n"
        try:
            logging.getLogger(name).setLevel(level.upper())
        except ValueError as e:
            return 400, "text/plain", f"{e}\n"
        return 200, "text/plain", f"{name} set to {level.upper()}\n"
    lines = ["logger                                   | effective level"]
    root = logging.getLogger()
    lines.append(f"{'<root>':41s}| "
                 f"{logging.getLevelName(root.getEffectiveLevel())}")
    for name in sorted(logging.root.manager.loggerDict):
        logger = logging.getLogger(name)
        lines.append(f"{name:41s}| "
                     f"{logging.getLevelName(logger.getEffectiveLevel())}")
    return 200, "text/plain", "\n".join(lines) + "\n"


def _dir_handler(server, req):
    """/dir/<path>: the server's files (a debug page, with the console's
    trust)."""
    rel = req.path[len("/dir"):] or "/"
    path = rel if rel.startswith("/") else "/" + rel
    if not os.path.exists(path):
        return 404, "text/plain", f"no such path: {path}\n"
    if os.path.isdir(path):
        lines = [f"{path}:"]
        try:
            for name in sorted(os.listdir(path)):
                try:
                    st = os.stat(os.path.join(path, name))
                    kind = "d" if stat.S_ISDIR(st.st_mode) else "-"
                    lines.append(f"{kind} {st.st_size:>12d}  {name}")
                except OSError:
                    lines.append(f"? {'?':>12s}  {name}")
        except PermissionError:
            return 403, "text/plain", f"permission denied: {path}\n"
        return 200, "text/plain", "\n".join(lines) + "\n"
    try:
        with open(path, "rb") as f:
            body = f.read(1 << 20)  # bounded, like the reference's page
    except OSError as e:
        return 403, "text/plain", f"{e}\n"
    return 200, "application/octet-stream", body


def _ids_handler(server, req):
    """/ids: the call id slots; /ids?id=N one id."""
    from brpc_tpu_torch.bthread import id as bthread_id

    id_q = req.query.get("id")
    if id_q:
        try:
            idv = int(id_q)
        except ValueError:
            return 400, "text/plain", "id must be an integer\n"
        slot, version = bthread_id._resolve(idv)
        if slot is None:
            return 200, "text/plain", f"id {idv}: unknown slot\n"
        valid = bthread_id._valid(slot, version)
        return 200, "text/plain", (
            f"id {idv}: version={version} first_version="
            f"{slot.first_version} range={slot.range} "
            f"locked={slot.locked} destroyed={slot.destroyed} "
            f"valid={valid} pending_errors={len(slot.pending_errors)}\n")
    with bthread_id._registry_lock:
        slots = list(bthread_id._slots.values())
    live = sum(1 for s in slots if not s.destroyed)
    locked = sum(1 for s in slots if s.locked)
    return 200, "text/plain", (
        f"id_slots: {len(slots)}\nlive: {live}\nlocked: {locked}\n"
        "use /ids?id=N for one id\n")


def attach_console(server):
    server._builtin_handlers = {
        "hotspots": hotspots_handler,
        "pprof": pprof_handler,
        "threads": threads_handler,
        "status": _status_handler,
        "vars": _vars_handler,
        "flags": _flags_handler,
        "health": _health_handler,
        "connections": _connections_handler,
        "index": _index_handler,
        "version": _version_handler,
        "brpc_metrics": _metrics_handler,
        "protobufs": _protobufs_handler,
        "bthreads": _bthreads_handler,
        "sockets": _sockets_handler,
        "heap": _heap_handler,
        "growth": _growth_handler,
        "rpc_dump": _rpc_dump_handler,
        "rpcz": _rpcz_handler,
        "list": _list_handler,
        "vlog": _vlog_handler,
        "dir": _dir_handler,
        "ids": _ids_handler,
    }
    bvar.expose_flags_as_bvars()
