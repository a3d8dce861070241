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

Left out: rpcz spans, streams, HTTP fields, compression other than none
(the server refuses it), and authentication.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from brpc_tpu_torch import bvar
from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.bthread import timer_add, timer_del
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors

_client_count = bvar.Adder("rpc_client_calls")
_backup_count = bvar.Adder("rpc_backup_requests")
_retry_count = bvar.Adder("rpc_retries")

COMPRESS_NONE = 0


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
        self._server_socket = None
        # tensor lane: outbound tensors on the client; the inbound and
        # outbound RpcMeta on the server; the response's RpcMeta on the client
        self._outbound_tensors = None
        self._rpc_meta = None
        self._response_meta = None
        self._response_rpc_meta = None

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
        _client_count.update(1)

    def current_attempt_id(self) -> int:
        return self._call_id + 1 + self.retried_count

    def issue_rpc(self, locked: bool = False):
        """One attempt: select a socket, pack, write, arm the timers.
        ``locked`` says whether the caller holds the call id's lock (the
        retry and backup branches of _on_error do)."""
        from brpc_tpu_torch.rpc import tpu_std_protocol

        sock, rc = self._channel._select_socket(self)
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
            packet = tpu_std_protocol.pack_request(self._request_payload,
                                                   self, attempt_cid)
        except Exception as e:
            self.set_failed(errors.EREQUEST, f"fail to pack request: {e}")
            self._end_rpc(locked)
            return
        if sock.write(packet, id_wait=attempt_cid) != 0:
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
