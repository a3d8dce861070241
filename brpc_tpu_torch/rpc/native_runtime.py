"""The native-runtime mount of a Server (``use_native_runtime``).

Port of brpc_tpu/rpc/native_runtime.py. The port's native library
(brpc_tpu_torch/native) owns the port: accept, epoll or io_uring, fiber
readers, tpu_std framing and the socket write queues run in C++. Requests
with no native handler come to this mount's Python lane, a pool of
threads (the usercode_backup_pool discipline: Python user code never runs
on a fiber stack), and run the Python server path unchanged
(``process_request``: auth, interceptor, MethodStatus, spans), writing
their responses back through the native socket by a shim.

The lanes by kind: 0, a natively parsed tpu_std request; 1, raw bytes of
any other protocol (the device handshake, hulu, RTMP, ...), cut by the
Python InputMessenger of a per-connection session (the native port keeps
the one-port-all-protocols rule); 3 and 4, natively parsed HTTP and gRPC
requests; 5, stream frames; 6, redis commands. With ``py_workers`` and a
``py_worker_factory`` the HTTP and gRPC requests go to that many worker
processes over the shm lane (``python -m brpc_tpu_torch.rpc.shm_worker``).

A connection that starts with the device handshake is a raw session: its
endpoint lives on the session's shim, and its tensor frames are cut in
Python. The shim writes a response's bytes to the native socket, reading
any tensor on the card to the host first, so the wire bytes are the
Python listener's.
"""
from __future__ import annotations

import logging
import os
import struct
import subprocess
import sys
import threading
import time
from typing import Optional

from brpc_tpu_torch import native
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf, IOPortal
from brpc_tpu_torch.rpc import errors

_log = logging.getLogger(__name__)
WORKER_READY_S = 60  # a fresh interpreter imports torch and maps the lane
EINTERNAL = 2001  # the code the reference answers a failed dispatch with


class NativeSocketShim:
    """Quacks like a Socket for the server's response path: ``write``
    goes to the native runtime's write queue of this connection. The raw
    lane runs whole protocol sessions over it, so it carries the read
    portal and the matched protocol the InputMessenger expects, and the
    attributes protocols attach to a connection."""

    def __init__(self, sock_id: int):
        self.sock_id = sock_id
        self.remote_side: Optional[EndPoint] = None
        self.app_state = None
        self._failed = False
        self.read_portal = IOPortal()
        self.matched_protocol = None

    def write(self, buf: IOBuf, id_wait=None) -> int:
        # a tensor on the card is read to the host here, once
        return native.sock_write(self.sock_id, buf.copy_to_bytes())

    def set_failed(self, error_code=0, error_text: str = "", **_):
        self._failed = True
        native.sock_set_failed(self.sock_id)

    def failed(self) -> bool:
        return self._failed

    def fd(self):
        return None


class _NativeHttpShim(NativeSocketShim):
    """The response path of a natively parsed HTTP request (kind 3): the
    serialized response goes to ``http_respond``, which keeps pipelined
    responses in request order. Connection: close is honoured natively,
    so the ECLOSE failure http_protocol raises after such a response is
    a no-op here (a hard failure would race earlier responses)."""

    def __init__(self, sock_id: int, seq: int):
        super().__init__(sock_id)
        self.seq = seq
        # a server span armed by the dispatch ends at the response write,
        # with the response's status
        self.span = None

    def _end_span(self, data):
        span, self.span = self.span, None
        if span is None:
            return
        try:
            status = int(bytes(data[9:12])) if data[:5] == b"HTTP/" else 0
        except ValueError:
            status = 0
        span.end(status if status >= 400 else 0)

    def write(self, buf, id_wait=None) -> int:
        data = buf.copy_to_bytes()
        self._end_span(data)
        return native.http_respond(self.sock_id, self.seq, data)

    def set_failed(self, error_code=0, error_text: str = "", **_):
        self._failed = True
        if error_code == errors.ECLOSE:
            return  # closed natively once this response is flushed
        span, self.span = self.span, None
        if span is not None:
            span.end(error_code or 500)
        native.sock_set_failed(self.sock_id)


class _StreamSession:
    """A connection's natively cut stream frames (kind 5), put back in
    order (the lane's threads race) and fed to the Python Stream objects,
    without parsing the framing again in Python."""

    FRAME_DATA = 0
    FRAME_FEEDBACK = 1
    FRAME_CLOSE = 2

    def __init__(self, sock_id: int):
        self.sock_id = sock_id
        self.lock = threading.Lock()
        self.pending = {}
        self.next_seq = 1
        self.busy = False

    def feed(self, seq: int, ftype: int, dest_id: int, payload: bytes):
        with self.lock:
            self.pending[seq] = (ftype, dest_id, payload)
            if self.busy:
                return
            self.busy = True
        while True:
            with self.lock:
                item = self.pending.pop(self.next_seq, None)
                if item is None:
                    self.busy = False
                    return
                self.next_seq += 1
            try:
                self._dispatch(*item)
            except Exception:
                _log.exception("native stream frame dispatch raised")

    def _dispatch(self, ftype: int, dest_id: int, payload: bytes):
        from brpc_tpu_torch.rpc.stream import Stream

        stream = Stream.find(dest_id)
        if stream is None:
            return  # closed already: dropped, as in the reference
        if ftype == self.FRAME_DATA:
            stream._on_data(IOBuf(payload))
        elif ftype == self.FRAME_FEEDBACK:
            (consumed,) = struct.unpack(">Q", payload)
            stream._on_feedback(consumed)
        elif ftype == self.FRAME_CLOSE:
            stream.close(notify_remote=False)


class _RawSession:
    """A connection of the raw lane: the native runtime hands over ordered
    byte chunks, and the Python InputMessenger cuts and runs them as it
    would from a socket. Chunks may arrive on any lane thread; they are
    put back in order and drained by one thread at a time."""

    def __init__(self, messenger, sock_id: int):
        self.messenger = messenger
        self.sock = NativeSocketShim(sock_id)
        self.lock = threading.Lock()
        self.chunks = {}
        self.next_seq = 1
        self.busy = False

    def feed(self, seq: int, data: bytes):
        with self.lock:
            self.chunks[seq] = data
            if self.busy:
                return  # the active drainer takes it
            self.busy = True
        while True:
            with self.lock:
                got = False
                while self.next_seq in self.chunks:
                    self.sock.read_portal.append(
                        self.chunks.pop(self.next_seq))
                    self.next_seq += 1
                    got = True
                if not got:
                    self.busy = False
                    return
            try:
                self.messenger._cut_and_process(self.sock, read_eof=False)
            except Exception:
                _log.exception("raw-lane protocol session raised")
                self.sock.set_failed()


class NativeRuntimeMount:
    """Runs a Server's services on a native port."""

    def __init__(self, server, num_threads: int = 0):
        self.server = server
        self.port = 0
        self._threads = []
        self._stopping = False
        self._num_threads = num_threads or max(2, server.options.num_threads)
        self._messenger = None
        self._raw_sessions = {}
        self._stream_sessions = {}
        self._raw_lock = threading.Lock()
        self._shm_workers = []
        self.io_uring = False

    def start(self, ip: str = "127.0.0.1", port: int = 0,
              native_echo: bool = False) -> int:
        self.port = native.rpc_server_start(ip, port, nworkers=0,
                                            native_echo=native_echo)
        try:
            self._mount()
        except BaseException:
            self.stop()  # the native server, its lane and any worker
            raise
        return self.port

    def _mount(self):
        from brpc_tpu_torch import rpcz  # noqa: F401  (the rpcz flags)
        from brpc_tpu_torch.butil import flags
        from brpc_tpu_torch.bvar.native_vars import register_native_bvars
        from brpc_tpu_torch.rpc.input_messenger import InputMessenger
        from brpc_tpu_torch.rpc.protocol import list_server_protocols

        self.io_uring = native.use_io_uring(True) == 1
        # one pane of glass: the C++ stat cells become variables (/vars,
        # /status, /brpc_metrics), and sampled native spans drain into
        # /rpcz
        register_native_bvars()
        if flags.get_flag("enable_rpcz"):
            native.stats_enable_spans(max(1, flags.get_flag("rpcz_sample_every")))
        # every registered protocol on the raw lane: the native port keeps
        # the Python port's one port for all
        protocols = list_server_protocols()
        opts = self.server.options
        if opts.enabled_protocols:
            protocols = [p for p in protocols if p.name in opts.enabled_protocols]
        self._messenger = InputMessenger(protocols, arg=self.server)
        native.rpc_server_enable_raw_fallback(True)
        # HTTP/1.1 and h2 parse natively and run in Python (kinds 3, 4)
        if any(p.name in ("http", "h2:grpc") for p in protocols):
            native.rpc_server_native_http(True)
        # RESP parses natively (kind 6); with native_redis_store the GET/SET
        # family runs on a native store and the rest reaches Python
        if self.server.redis_service is not None:
            native.rpc_server_redis(2 if opts.native_redis_store else 1)
        if opts.ssl_certfile:
            rc = native.rpc_server_ssl(opts.ssl_certfile, opts.ssl_keyfile)
            if rc != 0:
                raise RuntimeError(f"native TLS unavailable (rc={rc}): "
                                   f"libssl missing or bad cert/key")
        for i in range(self._num_threads):
            t = threading.Thread(target=self._worker,
                                 name=f"native_py_lane_{i}", daemon=True)
            t.start()
            self._threads.append(t)
        if opts.py_workers > 0 and opts.py_worker_factory:
            self._start_shm_workers(opts.py_workers, opts.py_worker_factory)

    def _start_shm_workers(self, n: int, factory: str):
        lib = native.load()
        # the lane's per-worker rings are carved at create: extra workers
        # would fail to attach and exit, so clamp, loudly
        max_workers = lib.nat_shm_lane_max_workers()
        if n > max_workers:
            _log.warning("py_workers=%d exceeds the shm lane's %d worker "
                         "slots; clamping", n, max_workers)
            n = max_workers
        # the workers share the process's one lane segment with the tensor
        # fabric, which a TensorStore server's start armed before this
        # mount (the segment then has the fabric's arena size)
        if lib.nat_shm_lane_create(0) != 0:
            raise RuntimeError("shm lane creation failed")
        name = native.shm_lane_name()
        self._worker_cmd = (name, factory)
        self._shm_workers = [self._spawn_worker() for _ in range(n)]
        # route nothing to the rings before the workers attached: a fresh
        # interpreter takes seconds. A worker that dies at boot only lowers
        # the count awaited.
        deadline = time.monotonic() + WORKER_READY_S
        while time.monotonic() < deadline:
            alive = sum(1 for p in self._shm_workers if p.poll() is None)
            if alive == 0 or lib.nat_shm_lane_workers() >= alive:
                break
            time.sleep(0.05)
        lib.nat_shm_lane_enable(1)

    def _spawn_worker(self) -> subprocess.Popen:
        name, factory = self._worker_cmd
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.Popen([sys.executable, "-m",
                                 "brpc_tpu_torch.rpc.shm_worker", name,
                                 factory], env=env, cwd=os.getcwd())

    def shm_worker_pids(self):
        return [p.pid for p in self._shm_workers if p.poll() is None]

    def replace_dead_workers(self, wait_s: float = WORKER_READY_S) -> int:
        """Start a worker in place of each one that died (its slot was
        freed by the lane's recovery) and wait until it attached. Returns
        how many were started."""
        lib = native.load()
        lib.nat_shm_lane_recover_probe()  # frees the dead workers' slots
        dead = [i for i, p in enumerate(self._shm_workers)
                if p.poll() is not None]
        for i in dead:
            self._shm_workers[i] = self._spawn_worker()
        deadline = time.monotonic() + wait_s
        while dead and time.monotonic() < deadline:
            lib.nat_shm_lane_recover_probe()
            alive = sum(1 for p in self._shm_workers if p.poll() is None)
            if lib.nat_shm_lane_workers() >= alive:
                break
            time.sleep(0.05)
        return len(dead)

    def stop(self, quiesce_timeout_ms: int = 0):
        from brpc_tpu_torch.rpc import device_transport as dt

        # drain first, while the lane and the workers still serve: stop
        # accepting, lame-duck every connection, finish admitted work
        # (the workers' included) under the deadline, refuse new arrivals
        if quiesce_timeout_ms > 0:
            native.server_quiesce(quiesce_timeout_ms)
        self._stopping = True
        if self._shm_workers:
            # the workers share the process's lane segment with the fabric:
            # disabling it unlinks the segment, so the fabric goes with it
            if not dt._fabric_disarm():
                native.load().nat_shm_lane_enable(0)
            for p in self._shm_workers:
                p.terminate()
            for p in self._shm_workers:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            self._shm_workers = []
        native.rpc_server_stop()
        for t in self._threads:
            t.join(timeout=2.0)
        with self._raw_lock:
            self._raw_sessions.clear()
            self._stream_sessions.clear()

    # -- the Python lane -----------------------------------------------------------
    def _worker(self):
        while not self._stopping:
            for item in native.take_requests(16, 100):
                self._dispatch_one(item)

    def _dispatch_one(self, item):
        from brpc_tpu_torch.rpc.proto.wire import RpcMeta
        from brpc_tpu_torch.rpc.tpu_std_protocol import RpcMessage, process_request

        (handle, kind, meta_bytes, payload, attachment, sock_id, seq,
         f0, f1, aux) = item
        if kind != 0:
            native.req_free(handle)
        if kind == 5:
            with self._raw_lock:
                sess = self._stream_sessions.get(sock_id)
                if sess is None:
                    sess = self._stream_sessions[sock_id] = _StreamSession(sock_id)
            sess.feed(seq, f0, aux, payload)
        elif kind == 3:
            self._handle_http(f0, f1, meta_bytes, payload, sock_id, seq)
        elif kind == 4:
            self._handle_grpc(f1, meta_bytes, payload, sock_id, seq)
        elif kind == 6:
            self._handle_redis(payload, sock_id, seq)
        elif kind == 1:
            with self._raw_lock:
                sess = self._raw_sessions.get(sock_id)
                if sess is None:
                    sess = self._raw_sessions[sock_id] = _RawSession(
                        self._messenger, sock_id)
            sess.feed(seq, payload)
        elif kind == 2:  # connection closed
            with self._raw_lock:
                sess = self._raw_sessions.pop(sock_id, None)
                self._stream_sessions.pop(sock_id, None)
            ep = sess.sock.app_state if sess is not None else None
            if ep is not None and hasattr(ep, "release_all"):
                ep.release_all()  # no ACK can come on a closed connection
        elif kind == 0:
            try:
                meta = RpcMeta()
                meta.ParseFromString(meta_bytes)
                msg = RpcMessage(meta, payload, IOBuf(attachment))
                msg.socket = NativeSocketShim(sock_id)
                msg.arg = self.server
                process_request(msg)
            except Exception as e:  # answer rather than drop
                native.respond(handle, EINTERNAL, f"py-lane dispatch: {e}")
                handle = None
            finally:
                if handle is not None:
                    native.req_free(handle)

    def _handle_grpc(self, path: bytes, flat_headers: bytes, data: bytes,
                     sock_id: int, sid: int):
        """kind 4: the native h2 session decoded the headers and buffered
        the gRPC-framed body; dispatch as the Python h2 stack does and
        answer through the native framer."""
        from brpc_tpu_torch import rpcz
        from brpc_tpu_torch.rpc.controller import Controller
        from brpc_tpu_torch.rpc.h2_protocol import (
            GRPC_INTERNAL,
            GRPC_NOT_FOUND,
            GRPC_OK,
            GRPC_RESOURCE_EXHAUSTED,
            GRPC_UNIMPLEMENTED,
            _parse_grpc_timeout,
            error_to_grpc_status,
            grpc_unwrap,
        )

        def respond(payload=b"", status=GRPC_OK, message=""):
            native.grpc_respond(sock_id, sid, payload, status, message)

        try:
            server = self.server
            pstr = path.decode("latin-1")
            parts = [p for p in pstr.split("/") if p]
            if len(parts) != 2:
                return respond(b"", GRPC_UNIMPLEMENTED, f"bad path {pstr}")
            entry = server.find_method(parts[0], parts[1])
            if entry is None:
                missing = server.find_service(parts[0]) is None
                return respond(
                    b"", GRPC_NOT_FOUND if missing else GRPC_UNIMPLEMENTED,
                    f"unknown method {pstr}")
            service_obj, minfo, method_status = entry
            headers = {}
            for line in flat_headers.decode("latin-1").split("\n"):
                if line:
                    k, _, v = line.partition(": ")
                    headers[k] = v
            # chained under the caller's span when x-bd-trace-* metadata
            # came with the request (hex)
            span = None
            tid = headers.get("x-bd-trace-id")
            if tid:
                try:
                    span = rpcz.Span(
                        "server", f"grpc {pstr}", trace_id=int(tid, 16),
                        parent_span_id=int(headers.get("x-bd-span-id") or "0",
                                           16))
                except ValueError:
                    span = None
            cntl = Controller()
            cntl.server = server
            cntl.service_name, cntl.method_name = parts[0], parts[1]
            cntl.server_start_time = time.monotonic()
            timeout = headers.get("grpc-timeout")
            if timeout:
                cntl.timeout_ms = _parse_grpc_timeout(timeout)
            if not method_status.on_requested():
                return respond(b"", GRPC_RESOURCE_EXHAUSTED,
                               "reached max_concurrency")
            request = minfo.request_class()
            body = grpc_unwrap(data)
            try:
                if body:
                    request.ParseFromString(body)
            except Exception as e:
                method_status.on_response(errors.EREQUEST,
                                          cntl.server_start_time)
                return respond(b"", GRPC_INTERNAL,
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
                    respond(b"", error_to_grpc_status(cntl.error_code_value),
                            cntl.error_text_value)
                else:
                    respond(response.SerializeToString(), GRPC_OK)
                # the span ends when the call completes, which may be on
                # another thread after the handler returned
                if span is not None:
                    span.end(cntl.error_code_value)

            try:
                if span is not None:
                    with rpcz.parent_scope(span):
                        minfo.handler(service_obj, cntl, request, response,
                                      done)
                else:
                    minfo.handler(service_obj, cntl, request, response, done)
            except Exception as e:
                if not responded[0]:
                    cntl.set_failed(errors.EINVAL, f"method raised: {e}")
                    done()
        except Exception as e:
            respond(b"", GRPC_INTERNAL, f"py-lane grpc dispatch: {e}")

    def _handle_redis(self, packed: bytes, sock_id: int, seq: int):
        """kind 6: argv parsed natively (a count, then (length, bytes)
        pairs); run the RedisService and answer in order through the
        native window."""
        from brpc_tpu_torch.rpc.redis import RedisReply

        try:
            (count,) = struct.unpack_from(">I", packed, 0)
            pos = 4
            args = []
            for _ in range(count):
                (n,) = struct.unpack_from(">I", packed, pos)
                pos += 4
                args.append(packed[pos:pos + n])
                pos += n
            service = self.server.redis_service
            reply = (RedisReply.error("ERR no redis service")
                     if service is None else service.dispatch(args))
        except Exception as e:
            reply = RedisReply.error(f"ERR dispatch raised: {e}")
        try:
            encoded = reply.encode()
        except Exception as e:
            # the seq must be answered, or the window wedges the connection
            encoded = RedisReply.error(f"ERR bad reply object: {e}").encode()
        native.redis_respond(sock_id, seq, encoded)

    def _handle_http(self, verb: bytes, uri: bytes, flat_headers: bytes,
                     body: bytes, sock_id: int, seq: int):
        """kind 3: rebuild the HttpRequest from the natively parsed fields
        and run the Python HTTP server path (restful map, console, RPC
        over HTTP). Pipelined order is kept natively, so requests of one
        connection may run at once."""
        from brpc_tpu_torch import rpcz
        from brpc_tpu_torch.rpc.http_message import HttpRequest
        from brpc_tpu_torch.rpc.http_protocol import (
            HttpInputMessage,
            process_request as http_process_request,
        )

        shim = None
        try:
            req = HttpRequest(verb.decode("latin-1"), uri.decode("latin-1"))
            hd = req.headers._headers
            for line in flat_headers.decode("latin-1").split("\n"):
                if line:
                    k, _, v = line.partition(": ")
                    hd[k] = v  # lowercased natively
            if body:
                req.body = IOBuf(body)
            msg = HttpInputMessage(req)
            shim = _NativeHttpShim(sock_id, seq)
            msg.socket = shim
            msg.arg = self.server
            tid = hd.get("x-bd-trace-id")
            if tid:
                # ends at the response write: a handler may answer later
                shim.span = rpcz.Span(
                    "server", f"{req.method} {req.uri}", trace_id=int(tid, 16),
                    parent_span_id=int(hd.get("x-bd-span-id") or "0", 16))
                with rpcz.parent_scope(shim.span):
                    http_process_request(msg)
            else:
                http_process_request(msg)
        except Exception as e:
            # blew up before a response reached the shim: the span still
            # ends, and the request is answered
            if shim is not None and shim.span is not None:
                span, shim.span = shim.span, None
                span.end(500)
            text = f"{e}\n".encode()
            resp = (f"HTTP/1.1 500 Internal Server Error\r\n"
                    f"Content-Length: {len(text)}\r\n\r\n").encode() + text
            native.http_respond(sock_id, seq, resp)
