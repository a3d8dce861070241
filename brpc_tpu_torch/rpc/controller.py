"""Controller — the per-RPC state on both sides.

Port of the part of brpc_tpu/rpc/controller.py the tensor lane reads. The
field names are the reference's, so tensor_service.py reads like its
counterpart: ``timeout_ms``, ``_outbound_tensors``,
``request_attachment``, ``response_attachment``, ``_rpc_meta``,
``_response_meta``, ``_response_rpc_meta``, ``_server_socket``,
``_current_sock``, ``failed()``, ``set_failed`` and ``error_code``.
Retries, backup requests, streams and tracing come with the
reference-grade channel.
"""
from __future__ import annotations

from typing import Optional

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors

COMPRESS_NONE = 0


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
        self._method_full_name = ""
        self._deadline: Optional[float] = None  # time.monotonic() seconds
        self._response = None
        self._current_sock = None
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
