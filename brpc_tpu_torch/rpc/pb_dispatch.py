"""The server half shared by the pb-rpc protocols of the legacy family.

Port of brpc_tpu/rpc/pb_dispatch.py: hulu and sofa (and the nshead pb
adaptor bound to a method) run one sequence: find the method through
the server's ``find_method`` (an unknown service is ENOSERVICE, an
unknown method ENOMETHOD), ask its MethodStatus (a limiter's refusal is
ELIMIT), decompress and parse the request (a failure of either is
EREQUEST "fail to parse request"), then run the handler with a ``done``
that records the call on the method's status (so ``/status`` and
``/vars`` count it as they count a tpu_std call) and sends the response
once. A handler that raises before ``done`` is answered with EINVAL.
The protocol's ``send_response(cntl, response_or_None)`` owns the wire
format. ``serialize_request`` is the family's client half: a message's
bytes, or bytes as they are (a replay). tpu_std keeps its richer path
(the interceptor, spans, session data, tensors) in
rpc/tpu_std_protocol.py.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from brpc_tpu_torch.rpc import compress, errors
from brpc_tpu_torch.rpc.controller import Controller


def serialize_request(request, cntl: Controller) -> bytes:
    if request is None:
        return b""
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    return request.SerializeToString()


def dispatch_pb_request(server, sock, service_name: str, method_name: str,
                        payload: bytes, compress_type: int,
                        send_response: Callable,
                        cntl: Optional[Controller] = None):
    """Runs the request; ``send_response(cntl, response_or_None)`` is
    called exactly once, later if the handler holds ``done``."""
    if cntl is None:
        cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl.service_name = service_name
    cntl.method_name = method_name
    cntl._server_socket = sock
    cntl.server_start_time = time.monotonic()

    if server is None:
        cntl.set_failed(errors.EINVAL, "no server bound to connection")
        return send_response(cntl, None)

    entry = server.find_method(service_name, method_name)
    if entry is None:
        missing_service = server.find_service(service_name) is None
        cntl.set_failed(
            errors.ENOSERVICE if missing_service else errors.ENOMETHOD,
            f"unknown {service_name}.{method_name}")
        return send_response(cntl, None)
    service_obj, method_info, method_status = entry

    if not method_status.on_requested():
        cntl.set_failed(errors.ELIMIT, "reached max_concurrency")
        return send_response(cntl, None)

    request = method_info.request_class()
    try:
        payload = compress.decompress(payload, compress_type)
        if payload:
            request.ParseFromString(payload)
    except Exception as e:
        method_status.on_response(errors.EREQUEST, cntl.server_start_time)
        cntl.set_failed(errors.EREQUEST, f"fail to parse request: {e}")
        return send_response(cntl, None)

    response = method_info.response_class()
    responded = [False]

    def done():
        if responded[0]:
            return
        responded[0] = True
        method_status.on_response(cntl.error_code_value,
                                  cntl.server_start_time)
        send_response(cntl, response)

    try:
        method_info.handler(service_obj, cntl, request, response, done)
    except Exception as e:
        if not responded[0]:
            cntl.set_failed(errors.EINVAL, f"method raised: {e}")
            done()
