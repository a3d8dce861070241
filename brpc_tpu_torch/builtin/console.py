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

A process whose native runtime is loaded (a ``use_native_runtime``
server) also shows the runtime's section of ``/status``, its sockets on
``/connections``, ``/heap/native`` and ``/growth/native`` (live native
bytes by allocation site, and their growth), the native recorder's state
on ``/rpc_dump`` and its capture window ``/rpc_dump?seconds=N[&every=M]
[&dir=PATH]``, which replays with ``rpc_replay --native``. A page reads
only a library the process has loaded and never builds one (queue C
#38); without one it answers what the reference answers without its
runtime. Left out: the page of a module not ported yet, ``/fleet``.
"""
from __future__ import annotations

import json
import logging
import os
import stat
import time
from xml.sax.saxutils import escape

from brpc_tpu_torch import bvar, native, rpcz
from brpc_tpu_torch.builtin import hotspots
from brpc_tpu_torch.builtin.hotspots import (
    _NATIVE_UNAVAILABLE,
    _ProfWindow,
    hotspots_handler,
    pprof_handler,
    threads_handler,
)
from brpc_tpu_torch.butil import flags as flags_mod
from brpc_tpu_torch.bvar.native_vars import (
    connection_rates,
    native_status_lines,
    prune_connection_windows,
)
from brpc_tpu_torch.rpc import rpc_dump  # noqa: F401 (defines its flags)

# one native capture window at a time: the recorder is one resource, and
# a second /rpc_dump?seconds= while one runs gets 503 and Retry-After
_rpc_dump_window = _ProfWindow(
    30.0, "rpc_dump busy: another /rpc_dump capture window is running\n")


def _version() -> str:
    import brpc_tpu_torch

    return f"brpc_tpu_torch/{brpc_tpu_torch.__version__}"


def _status_handler(server, req):
    """/status: the server and each method's stats, and the native
    runtime's section when it carried traffic."""
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
    lines += native_status_lines()
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


def _native_socket_lines(rows) -> list:
    """/connections' native table: one row per live native socket, its
    byte counters with their windowed rates."""
    lines = ["", "native sockets:",
             "remote_side          |socket_id          |proto   |side  |"
             "disp|in_bytes(/s)        |out_bytes(/s)       |in_msg  |"
             "out_msg |rd_sys  |wr_sys  |unwritten |mem_bytes"]
    prune_connection_windows(r["sock_id"] for r in rows)
    total_mem = 0
    for r in sorted(rows, key=lambda r: r["sock_id"]):
        rates = connection_rates(r["sock_id"])
        in_cell = f"{r['in_bytes']}({rates['in_Bps']:,.0f}/s)"
        out_cell = f"{r['out_bytes']}({rates['out_Bps']:,.0f}/s)"
        total_mem += r["mem_bytes"]
        lines.append(
            f"{r['remote'] or '?':21s}|{r['sock_id']:<19d}|"
            f"{r['protocol']:8s}|{'srv' if r['server_side'] else 'cli':6s}|"
            f"{r['disp_idx']:<4d}|{in_cell:<20s}|{out_cell:<20s}|"
            f"{r['in_msgs']:<8d}|{r['out_msgs']:<8d}|"
            f"{r['read_calls']:<8d}|{r['write_calls']:<8d}|"
            f"{r['unwritten_bytes']:<10d}|{r['mem_bytes']}")
    lines.append(f"native socket buffered memory: {total_mem} bytes "
                 f"across {len(rows)} sockets")
    return lines


def _connections_handler(server, req):
    """/connections: the server's connections, and the native runtime's
    sockets when it is loaded."""
    lines = ["remote_side          |socket_id          |state"]
    for sock in server.list_connections():
        lines.append(
            f"{str(sock.remote_side):21s}|{sock.socket_id:<19d}|"
            f"{'failed' if sock.failed() else 'ok'}")
    rows = native.conn_snapshot() if native.is_loaded() else []
    if rows:
        lines += _native_socket_lines(rows)
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


def _native_window(req, body_fn):
    """/heap/native and /growth/native: ``body_fn(seconds)`` under the
    allocation tracker's one window."""
    try:
        seconds = float(req.query.get("seconds", "0") or 0)
    except ValueError:
        return 400, "text/plain", "seconds must be a number\n"
    return hotspots._res_prof_window.run(max(0.1, seconds),
                                         lambda _: body_fn(seconds))


def _is_native(req) -> bool:
    parts = [p for p in req.path.split("/") if p]
    return len(parts) > 1 and parts[1] == "native"


def _heap_handler(server, req):
    """/heap: live allocations by site (tracemalloc); /heap/native the
    native allocators' (``?flat=1`` a table, ``?seconds=N`` watching N
    seconds first)."""
    from brpc_tpu_torch.builtin import profilers

    if _is_native(req):
        flat = req.query.get("flat", "") not in ("", "0")
        return _native_window(
            req, lambda s: hotspots.heap_native(s, flat=flat))
    return 200, "text/plain", profilers.heap_profile()


def _growth_handler(server, req):
    """/growth: allocation growth since profiling started (tracemalloc);
    /growth/native the native allocators' since the baseline
    (``?seconds=N``: that window's growth)."""
    from brpc_tpu_torch.builtin import profilers

    if _is_native(req):
        return _native_window(req, hotspots.growth_native)
    return 200, "text/plain", profilers.growth_profile()


def _rpcz_handler(server, req):
    """/rpcz: the newest spans; ?trace_id=<hex> one trace."""
    return 200, "text/plain", rpcz.describe_recent_spans(req.query)


def _native_recorder_lines(st) -> list:
    lines = [f"native recorder: {'RUNNING' if st['running'] else 'stopped'}"
             f"  sample_every={st['every']}  seed={st['seed']}",
             f"  window: samples={st['samples']} written={st['written']} "
             f"bytes={st['bytes']} drops={st['drops']} "
             f"oversize={st['oversize']} rotations={st['rotations']}",
             f"  config: dir={st['dir'] or '(unset)'} "
             f"max_file_bytes={st['max_file_bytes']} "
             f"generations={st['generations']} "
             f"max_payload={st['max_payload']}"]
    if st["dir"]:
        try:
            names = sorted(n for n in os.listdir(st["dir"])
                           if n.endswith(".rio"))
        except OSError:
            names = []
        lines.append(f"  capture files ({len(names)}):")
        for n in names:
            try:
                size = os.path.getsize(os.path.join(st["dir"], n))
            except OSError:
                size = 0
            lines.append(f"    {n}  {size} bytes")
    return lines


def _rpc_dump_status_body():
    """/rpc_dump's status: the native recorder (its window's counts, its
    settings and capture files) and the Python lane's recorder flags."""
    lines = ["traffic flight recorder (rpc_dump)", ""]
    if native.is_loaded():
        lines += _native_recorder_lines(native.dump_status())
    else:
        lines.append("native recorder: unavailable (no native runtime)")
    lines += ["",
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
    """/rpc_dump: the recorders' status; ?seconds=N arms the native
    recorder for N seconds (one window at a time) and then answers the
    status."""
    seconds = req.query.get("seconds")
    if not seconds:
        return 200, "text/plain", _rpc_dump_status_body()
    if not native.is_loaded():
        return 200, "text/plain", _NATIVE_UNAVAILABLE
    try:
        every = int(req.query.get("every", "1") or 1)
    except ValueError:
        return 400, "text/plain", "every must be an integer\n"
    try:
        window_s = float(seconds)
    except ValueError:
        return 400, "text/plain", "seconds must be a number\n"
    directory = req.query.get("dir") or flags_mod.get_flag("rpc_dump_dir")

    def capture(s):
        rc = native.dump_start(directory, every=max(1, every))
        if rc == -1:  # an embedder owns the recorder: report, don't take it
            return ("recorder already armed by the embedder:\n\n"
                    + _rpc_dump_status_body())
        if rc != 0:
            return f"could not start capture under {directory!r}\n"
        time.sleep(s)
        native.dump_stop()
        return _rpc_dump_status_body()

    return _rpc_dump_window.run(window_s, capture)


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
