"""Controller — the per-RPC state on both sides.

Port of brpc_tpu/rpc/controller.py. On the client it carries the
deadline, the retry and backup-request state and drives each attempt
(``issue_rpc``) through the channel's socket selection. The call id is a
ranged bthread id: version v+1+k addresses attempt k, so a response to
an abandoned attempt is never taken for the live one, and the response,
the deadline timer, the backup timer and a socket failure all decide the
RPC's end under the one id lock (``_on_error`` and ``_on_response`` run
locked; the first to end the RPC destroys the id, and whatever comes
later finds it stale and is dropped).

The tensor lane's fields keep the reference's names: ``_outbound_tensors``
(packed once per attempt, on that attempt's connection),
``_response_rpc_meta``, and on the server ``_rpc_meta``,
``_response_meta`` and ``_server_socket``. After the RPC,
``_current_sock`` is the connection that served the winning attempt (the
reference leaves the last attempt's there), so an ACK in the response
reaches the endpoint that retains the send. The sends of the other
attempts are released by the controller: when their late response
arrives, or when their connection fails (ROADMAP queue C #9).

Streams: ``_request_stream`` is the client's stream riding the request;
the winning response binds it to the connection that served it. On the
server, ``_remote_stream_id`` is the client's stream id and
``_accepted_stream`` the stream the handler accepted.

Each attempt is packed by the channel's protocol (``tpu_std``,
``http``, ``h2:grpc`` or one of the legacy and key-value protocols); a
protocol's ``on_packed`` hook runs under the socket's write lock as the
request is queued (HTTP, redis, memcache and nshead keep their
correlation ids in request order there). A protocol whose response
carries no RpcMeta ends its attempt through ``lock_attempt`` and
``_on_protocol_response``. ``http_request`` and ``http_response`` are
the HTTP messages of a call over HTTP, on either side.

Tracing and compression: ``_setup_call`` opens the call's rpcz client
span (rpcz.py), whose ids the request's meta carries, and the RPC's end
closes it once, with the winning connection's ``remote_side``: the
attempts of one RPC (retries, a backup request) share it. On the server,
``trace_id`` and ``span`` are the request's. ``compress_type`` (the
``COMPRESS_*`` codes of rpc/compress.py) compresses the request's
payload, and on the server the response's, never an attachment.
``close_connection()`` in a handler closes the connection after the
response is sent. ``reset()`` makes a used controller new. On the
server, ``auth_context`` is what the server's authenticator made of the
request's credential (``client_credential`` and ``verify_credential``
are the two halves tpu_std and hulu share).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch import bvar, rpcz
from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.bthread import timer_add, timer_del
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.compress import (  # noqa: F401
    COMPRESS_GZIP,
    COMPRESS_NONE,
    COMPRESS_SNAPPY,
    COMPRESS_ZLIB,
)

_client_count = bvar.Adder("rpc_client_calls")
_backup_count = bvar.Adder("rpc_backup_requests")
_retry_count = bvar.Adder("rpc_retries")


class RetryPolicy:
    """Decides whether a failed attempt is retried (retry_policy.h)."""

    def do_retry(self, controller: "Controller") -> bool:
        # connection-level failures only; never a deadline or an error the
        # server answered with
        return controller.error_code in (
            errors.EFAILEDSOCKET,
            errors.ECLOSE,
            errors.ETIMEDOUT,  # connect timeout, not the RPC deadline
            errors.EEOF,
        )


DEFAULT_RETRY_POLICY = RetryPolicy()


class Controller:
    def __init__(self):
        self.reset()

    def reset(self):
        # shared
        self.error_code_value = 0
        self.error_text_value = ""
        self.request_attachment = IOBuf()
        self.response_attachment = IOBuf()
        self.compress_type = COMPRESS_NONE
        self.log_id = 0
        self.remote_side = None
        # client
        self.timeout_ms: Optional[float] = None
        self.max_retry: int = 3
        self.backup_request_ms: Optional[float] = None
        self.retry_policy: RetryPolicy = DEFAULT_RETRY_POLICY
        self.request_code = 0  # the key of the consistent-hashing balancers
        self.retried_count = 0
        self.has_backup_request = False
        self.latency_us = 0.0
        self._call_id = 0
        self._start_time = 0.0
        self._deadline: Optional[float] = None  # time.monotonic() seconds
        self._timeout_timer = None
        self._backup_timer = None
        self._done: Optional[Callable] = None
        self._ended = threading.Event()
        self._response = None
        self._request_payload = b""
        self._method_full_name = ""
        self._channel = None
        self._current_sock = None
        self._lb = None
        self._excluded_sids = set()
        self._accessed = []  # every socket an attempt went out on
        # (attempt call id, socket, DeviceEndpoint, seq) of each packed send
        self._sends: List[tuple] = []
        self._winner_cid = 0
        # server
        self.server = None
        self.service_name = ""
        self.method_name = ""
        self.server_start_time = 0.0  # time.monotonic() at arrival
        self.close_connection_flag = False
        self.session_local_data = None  # lent by the server's pool
        self.auth_context = None  # the verified credential's AuthContext
        self._server_socket = None
        # tensor lane: outbound tensors on the client; the inbound and
        # outbound RpcMeta on the server; the response's RpcMeta on the client
        self._outbound_tensors = None
        self._rpc_meta = None
        self._response_meta = None
        self._response_rpc_meta = None
        # streams (rpc/stream.py): the client's stream riding the request;
        # on the server the client's stream id and the accepted stream
        self._request_stream = None
        self._remote_stream_id = 0
        self._accepted_stream = None
        # http (http_protocol.py): request/response objects on either side
        self.http_request = None
        self.http_response = None
        # tracing (rpcz.py): the ids the request's meta carries
        self.trace_id = 0
        self.span_id = 0
        self.span = None

    # -- error state -------------------------------------------------------
    @property
    def error_code(self) -> int:
        return self.error_code_value

    @property
    def error_text(self) -> str:
        return self.error_text_value

    def failed(self) -> bool:
        return self.error_code_value != 0

    def set_failed(self, error_code: int, error_text: str = ""):
        self.error_code_value = error_code or errors.EINVAL
        self.error_text_value = error_text or errors.berror(self.error_code_value)

    def close_connection(self, reason: str = ""):
        """Server side: close the connection once the response is sent."""
        self.close_connection_flag = True

    # -- client call lifecycle ---------------------------------------------
    @property
    def call_id(self) -> int:
        return self._call_id

    def _setup_call(self, channel, method_full_name: str, response,
                    done: Optional[Callable]):
        self._channel = channel
        self._method_full_name = method_full_name
        self._response = response
        self._done = done
        self._start_time = time.monotonic()
        if self.timeout_ms is not None and self.timeout_ms >= 0:
            self._deadline = self._start_time + self.timeout_ms / 1000.0
        # versions: v names the RPC, v+1+k attempt k
        self._call_id = bthread_id.create_ranged(self, self._on_error,
                                                 self.max_retry + 2)
        self.span = rpcz.start_client_span(method_full_name, self)
        _client_count.update(1)

    def current_attempt_id(self) -> int:
        return self._call_id + 1 + self.retried_count

    def issue_rpc(self, locked: bool = False):
        """One attempt: select a socket, pack, write, arm the timers.
        ``locked`` says whether the caller holds the call id's lock (the
        retry and backup branches of _on_error do)."""
        channel = self._channel
        sock, rc = channel._select_socket(self)
        if rc != 0 or sock is None:
            self.set_failed(rc or errors.EFAILEDSOCKET, "no usable server")
            self._end_rpc(locked)
            return
        self._current_sock = sock
        if sock not in self._accessed:
            self._accessed.append(sock)
        self.remote_side = sock.remote_side
        attempt_cid = self.current_attempt_id()
        try:
            packet = channel._protocol.pack_request(self._request_payload,
                                                    self, attempt_cid)
        except Exception as e:
            self.set_failed(errors.EREQUEST, f"fail to pack request: {e}")
            self._end_rpc(locked)
            return
        on_packed = channel._protocol.on_packed
        on_queued = ((lambda: on_packed(sock, self, attempt_cid))
                     if on_packed is not None else None)
        if sock.write(packet, id_wait=attempt_cid, on_queued=on_queued) != 0:
            return  # the socket's failure already errored the attempt
        if self._deadline is not None and self._timeout_timer is None:
            remain = max(0.0, self._deadline - time.monotonic())
            self._timeout_timer = timer_add(remain, self._handle_timeout,
                                            self._call_id)
        if (self.backup_request_ms is not None and self.retried_count == 0
                and self._backup_timer is None):
            self._backup_timer = timer_add(self.backup_request_ms / 1000.0,
                                           self._handle_backup, self._call_id)

    # -- timer callbacks (on the timer thread) -----------------------------
    def _handle_timeout(self, cid: int):
        bthread_id.error(cid, errors.ERPCTIMEDOUT, "deadline exceeded")

    def _handle_backup(self, cid: int):
        bthread_id.error(cid, errors.EBACKUPREQUEST, "")

    # -- completion (runs under the id lock) -------------------------------
    def _on_error(self, idv: int, data, error_code: int, error_text: str):
        """The call id's on_error: a backup attempt, a retry, or the end."""
        if error_code == errors.EBACKUPREQUEST:
            # a second attempt on another server; the first stays in flight
            if self.retried_count < self.max_retry:
                self.retried_count += 1
                self.has_backup_request = True
                _backup_count.update(1)
                if self._current_sock is not None:
                    self._excluded_sids.add(self._current_sock.node_sid)
                self.issue_rpc(locked=True)
            self._unlock(idv)
            return
        self.set_failed(error_code, error_text)
        if (error_code != errors.ERPCTIMEDOUT
                and self.retried_count < self.max_retry
                and self.retry_policy.do_retry(self)
                and (self._deadline is None
                     or time.monotonic() < self._deadline)):
            self.retried_count += 1
            _retry_count.update(1)
            if self._current_sock is not None:
                self._excluded_sids.add(self._current_sock.node_sid)
            self.error_code_value = 0
            self.error_text_value = ""
            self.issue_rpc(locked=True)
            self._unlock(idv)
            return
        self._end_rpc(locked=True)

    @staticmethod
    def _unlock(idv: int):
        try:
            bthread_id.unlock(idv)
        except (KeyError, RuntimeError):
            pass  # issue_rpc failed synchronously and ended the RPC

    def _on_response(self, meta, payload: bytes, attachment: IOBuf, sock):
        """The response of attempt ``meta.correlation_id`` on ``sock``;
        called by the protocol with the id locked."""
        self._response_rpc_meta = meta
        self._current_sock = sock
        self.remote_side = sock.remote_side
        self._winner_cid = meta.correlation_id
        if meta.stream_id and self._request_stream is not None:
            # the stream was accepted: learn the peer's id, and send on
            # the connection that served this (the winning) attempt
            self._request_stream.peer_id = meta.stream_id
            self._request_stream.bind(sock)
        if meta.response.error_code != 0:
            self.set_failed(meta.response.error_code, meta.response.error_text)
        else:
            try:
                if self._response is not None and payload:
                    self._response.ParseFromString(payload)
                self.response_attachment = attachment
            except ValueError as e:
                self.set_failed(errors.EREQUEST, f"fail to parse response: {e}")
        self._end_rpc(locked=True)

    def _on_protocol_response(self, sock, attempt_cid: int):
        """The end of attempt ``attempt_cid``, answered on ``sock`` by a
        protocol that filled the response (or failed the call) itself;
        called with the id locked."""
        self._current_sock = sock
        self.remote_side = sock.remote_side
        self._winner_cid = attempt_cid
        self._end_rpc(locked=True)

    def _release_sends(self):
        """The winning send of a good RPC stays for the ACK in its
        response; a send whose response arrived with a failure is done; the
        rest are released by their late response or their socket's end."""
        for cid, sock, ep, seq in self._sends:
            if cid == self._winner_cid:
                if self.failed():
                    ep.on_ack(seq)
            else:
                sock.abandon_send(cid, ep, seq)
        self._sends = []

    def _end_rpc(self, locked: bool):
        """Cancel the timers, release the losers' sends, feed the load
        balancer and the channel, destroy the id, run done."""
        if self._timeout_timer is not None:
            timer_del(self._timeout_timer)
            self._timeout_timer = None
        if self._backup_timer is not None:
            timer_del(self._backup_timer)
            self._backup_timer = None
        self.latency_us = (time.monotonic() - self._start_time) * 1e6
        if self.span is not None:
            self.span.remote_side = (str(self.remote_side)
                                     if self.remote_side else None)
            self.span.end(self.error_code_value)
            self.span = None
        for sock in self._accessed:
            for k in range(self.max_retry + 1):
                sock.remove_inflight(self._call_id + 1 + k)
        self._release_sends()
        if self._lb is not None and self._current_sock is not None:
            try:
                self._lb.feedback(self._current_sock.node_sid,
                                  self.error_code_value, self.latency_us)
            except Exception:
                pass  # a balancer's fault must not lose the RPC's end
        if self._channel is not None:
            self._channel._on_rpc_end(self)
        cid = self._call_id
        if locked:
            bthread_id.unlock_and_destroy(cid)
        else:
            try:
                bthread_id.lock(cid)
                bthread_id.unlock_and_destroy(cid)
            except KeyError:
                pass
        done = self._done
        self._ended.set()
        if done is not None:
            done(self)

    def cancel(self):
        """End the RPC in flight with ECANCELED; done still runs."""
        if self._call_id and not self._ended.is_set():
            bthread_id.error(self._call_id, errors.ECANCELED, "cancelled")

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the RPC's end."""
        return self._ended.wait(timeout)


def client_credential(cntl: Controller) -> Optional[str]:
    """The credential of the call's channel's authenticator, None without
    one; raises when the authenticator refuses to make one (the attempt
    then fails to pack)."""
    channel = cntl._channel
    auth = getattr(getattr(channel, "options", None), "auth", None)
    if auth is None:
        return None
    cred = auth.generate_credential(cntl)
    if cred is None:
        raise ValueError("authenticator refused to generate credential")
    return cred


def verify_credential(server, cntl: Controller, credential, sock) -> bool:
    """True when the server has no authenticator or it accepts
    ``credential`` (its context goes to ``cntl.auth_context``); else the
    controller is failed with EAUTH."""
    auth = getattr(server, "auth", None)
    if auth is None:
        return True
    if isinstance(credential, bytes):
        credential = credential.decode("utf-8", "replace")
    try:
        ok, ctx = auth.verify_credential(credential, sock.remote_side)
    except Exception:
        ok, ctx = False, None
    if not ok:
        cntl.set_failed(errors.EAUTH, "authentication failed")
        return False
    cntl.auth_context = ctx
    return True


def lock_attempt(cid: int) -> Optional[Controller]:
    """The controller of attempt ``cid`` with its id locked, or None when
    the RPC has ended (a late answer to a timed-out or losing attempt)."""
    try:
        cntl = bthread_id.lock(cid)
    except (KeyError, TimeoutError):
        return None
    if not isinstance(cntl, Controller):
        Controller._unlock(cid)
        return None
    return cntl
