"""HTTP/1.1 — pb over HTTP and the builtin console, on the RPC port.

Port of brpc_tpu/rpc/http_protocol.py, with its routing and its bytes.

Server side, in the reference's order: a restful mapping
(``ServerOptions.restful_mappings``), then ``/Service/Method``, then a
builtin console page (``brpc_tpu_torch/builtin``), then the bad-method
page listing a known service's methods, then 404. A call over HTTP asks
the method's limiter first (503 with ``ELIMIT``), takes its request from
a JSON body, an ``application/proto`` body or the query parameters (a
body that does not parse is 400 with ``EREQUEST``, counted in the
method's status), and answers JSON or proto as it was asked; a failed
call maps its error to a status code (``http_status_from_error``) and
sends the code in ``x-error-code``. HEAD sends no body.
``Connection: close`` closes after the answer.

Client side (``ChannelOptions(protocol="http")``): the request goes as
JSON to ``POST /Service/Method``; responses on a connection come back in
request order, so each connection keeps a FIFO of correlation ids, filled
under the socket's write lock (``on_packed``). A non-200 answer fails the
call with its ``x-error-code`` or EHTTP. A server that answered
keep-alive and then answers ``Connection: close`` is draining: its
connection is marked lame duck. A server that closes after every answer
is not.

As in the reference, a call over HTTP runs no interceptor and borrows no
session data.

One fault of the reference is not copied (ROADMAP queue C #14): it runs
the HTTP messages of one read in parallel tasks, so pipelined requests
are answered out of order and responses read together go to the wrong
calls. The port processes HTTP messages in the reading task, in wire
order: a request's handler runs before the next request of its
connection is read.
"""
from __future__ import annotations

import json
import time
from collections import deque

from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.json2pb import json_to_pb_inplace, pb_to_json
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.http_message import HttpRequest, HttpResponse, try_parse
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

_STATUS_REASON = {200: "OK", 400: "Bad Request", 403: "Forbidden",
                  404: "Not Found", 500: "Internal Server Error",
                  503: "Service Unavailable"}


def http_status_from_error(code: int) -> int:
    """A framework error code as an HTTP status."""
    if code == 0:
        return 200
    return {
        errors.ENOSERVICE: 404,
        errors.ENOMETHOD: 404,
        errors.EREQUEST: 400,
        errors.EAUTH: 403,
        errors.EPERM: 403,
        errors.ELIMIT: 503,
        errors.EOVERLOAD: 503,
    }.get(code, 500)


class HttpInputMessage(InputMessageBase):
    __slots__ = ("http", "is_request")

    def __init__(self, http_msg):
        super().__init__()
        self.http = http_msg
        self.is_request = isinstance(http_msg, HttpRequest)


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    state, msg = try_parse(portal)
    if state == "ok":
        return ParseResult.ok(HttpInputMessage(msg))
    if state == "more":
        return ParseResult.not_enough()
    if state == "not_http":
        return ParseResult.try_others()
    return ParseResult.error_()


# -- server side -----------------------------------------------------------

def _respond(sock, response: HttpResponse, close: bool = False):
    response.reason = _STATUS_REASON.get(response.status_code,
                                         response.reason or "")
    response.headers.set("server", "brpc_tpu")
    if close:
        response.headers.set("connection", "close")
    out = response.serialize()
    body_len = len(response.body)
    if getattr(response, "_head_only", False) and body_len:
        # HEAD: the headers (the body's Content-Length too), no body
        out = IOBuf(out.copy_to_bytes(len(out) - body_len))
    sock.write(out)
    if close:
        sock.set_failed(errors.ECLOSE, "http connection: close")


def process_request(msg: HttpInputMessage):
    """Route one request: restful mapping, /Service/Method, console page,
    bad-method page, 404."""
    server = msg.arg
    req: HttpRequest = msg.http
    sock = msg.socket
    close = req.headers.get("connection", "").lower() == "close"
    resp = HttpResponse()
    resp._head_only = req.method == "HEAD"
    if server is None:
        resp.status_code = 500
        resp.set_body("no server bound")
        return _respond(sock, resp, close)

    parts = [p for p in req.path.split("/") if p]
    mapped = server.restful_map.get(req.path)
    if mapped is not None and server.find_method(*mapped) is not None:
        return _process_http_rpc(server, req, sock, resp, mapped[0],
                                 mapped[1], close)
    if len(parts) == 2 and server.find_method(parts[0], parts[1]) is not None:
        return _process_http_rpc(server, req, sock, resp, parts[0], parts[1],
                                 close)
    handlers = getattr(server, "_builtin_handlers", None)
    if handlers:
        handler = handlers.get(parts[0] if parts else "index")
        if handler is not None:
            extra_headers = None
            try:
                # (status, ctype, body) or, with extra headers (the busy
                # profiler's Retry-After), a 4-tuple
                out = handler(server, req)
                if len(out) == 4:
                    status, ctype, body, extra_headers = out
                else:
                    status, ctype, body = out
            except Exception as e:
                status, ctype, body = 500, "text/plain", f"handler raised: {e}"
            resp.status_code = status
            resp.set_body(body, ctype)
            for hk, hv in (extra_headers or {}).items():
                resp.headers.set(hk, hv)
            return _respond(sock, resp, close)
    svc = server.find_service(parts[0]) if parts else None
    if svc is not None:
        # a known service with a missing or wrong method lists its methods
        if len(parts) >= 2:
            first = f"fail to find method={parts[1]} in service={parts[0]}."
        else:
            first = f"Missing method name for service={parts[0]}."
        lines = [first, " Available methods are:", ""]
        for mname, minfo in sorted(svc.methods().items()):
            lines.append(f"rpc {mname} ({minfo.request_class.__name__}) "
                         f"returns ({minfo.response_class.__name__});")
        resp.status_code = 404
        resp.set_body("\n".join(lines) + "\n")
        return _respond(sock, resp, close)
    resp.status_code = 404
    resp.set_body(f"no such page or method: {req.path}\n")
    _respond(sock, resp, close)


def _process_http_rpc(server, req, sock, resp, service_name, method_name,
                      close):
    service_obj, minfo, method_status = server.find_method(service_name,
                                                           method_name)
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl.service_name = service_name
    cntl.method_name = method_name
    cntl.server_start_time = time.monotonic()
    cntl.http_request = req
    cntl.http_response = resp
    if not method_status.on_requested():
        cntl.set_failed(errors.ELIMIT, "reached max_concurrency")
        resp.status_code = 503
        resp.set_body(cntl.error_text_value)
        return _respond(sock, resp, close)

    request = minfo.request_class()
    body = req.body.to_bytes()
    ctype = (req.headers.get("content-type") or "application/json").lower()
    try:
        if "proto" in ctype:
            request.ParseFromString(body)
        elif body:
            if not json_to_pb_inplace(body.decode("utf-8"), request):
                raise ValueError("malformed JSON body")
        elif req.query:
            # query parameters fill fields too (restful convenience)
            json_to_pb_inplace(json.dumps(req.query), request)
    except Exception as e:
        method_status.on_response(errors.EREQUEST, cntl.server_start_time)
        resp.status_code = 400
        resp.set_body(f"fail to parse request: {e}")
        return _respond(sock, resp, close)

    response_pb = minfo.response_class()
    responded = [False]

    def done():
        if responded[0]:
            return
        responded[0] = True
        method_status.on_response(cntl.error_code_value,
                                  cntl.server_start_time)
        if cntl.failed():
            resp.status_code = http_status_from_error(cntl.error_code_value)
            resp.set_body(cntl.error_text_value + "\n")
            resp.headers.set("x-error-code", cntl.error_code_value)
        elif "proto" in ctype:
            resp.set_body(response_pb.SerializeToString(),
                          "application/proto")
        else:
            resp.set_body(pb_to_json(response_pb), "application/json")
        _respond(sock, resp, close)

    try:
        minfo.handler(service_obj, cntl, request, response_pb, done)
    except Exception as e:
        if not responded[0]:
            cntl.set_failed(errors.EINVAL, f"method raised: {e}")
            done()


# -- client side -----------------------------------------------------------

def serialize_request(request, cntl: Controller) -> bytes:
    return pb_to_json(request).encode("utf-8") if request is not None else b""


def pack_request(payload: bytes, cntl: Controller,
                 correlation_id: int) -> IOBuf:
    service, _, method = cntl._method_full_name.rpartition(".")
    req = cntl.http_request or HttpRequest()
    if req.uri == "/":
        req.uri = f"/{service}/{method}"
    if payload:
        req.method = "POST"
        req.body = IOBuf(payload)
        if "content-type" not in req.headers:
            req.headers.set("content-type", "application/json")
    req.headers.set("host", str(cntl.remote_side or ""))
    req.headers.set("x-correlation-id", correlation_id)
    return req.serialize()


def on_packed(sock, cntl: Controller, correlation_id: int):
    """Under the socket's write lock: the connection's FIFO of ids gets
    this request's, in wire order."""
    q = getattr(sock, "_http_pipeline", None)
    if q is None:
        q = sock._http_pipeline = deque()
    q.append(correlation_id)


def process_response(msg: HttpInputMessage):
    sock = msg.socket
    # keep-alive -> close is a draining server: calls in flight complete,
    # new calls go elsewhere; a close-per-response server is not draining
    if "close" in msg.http.headers.get("connection", "").lower():
        if getattr(sock, "_http_saw_keepalive", False):
            sock.mark_lame_duck()
    else:
        sock._http_saw_keepalive = True
    q = getattr(sock, "_http_pipeline", None)
    if not q:
        return
    cid = q.popleft()
    try:
        cntl = bthread_id.lock(cid)
    except (KeyError, TimeoutError):
        return  # its RPC ended already
    http_resp: HttpResponse = msg.http
    cntl.http_response = http_resp
    body = http_resp.body.to_bytes()
    if http_resp.status_code != 200:
        code_hdr = http_resp.headers.get("x-error-code")
        code = (int(code_hdr) if code_hdr and code_hdr.isdigit()
                else errors.EHTTP)
        cntl.set_failed(code, body.decode("utf-8", "replace").strip()
                        or f"http status {http_resp.status_code}")
        cntl._end_rpc(locked=True)
        return
    try:
        if cntl._response is not None and body:
            ctype = (http_resp.headers.get("content-type") or "").lower()
            if "proto" in ctype:
                cntl._response.ParseFromString(body)
            else:
                json_to_pb_inplace(body.decode("utf-8"), cntl._response)
    except Exception as e:
        cntl.set_failed(errors.EREQUEST, f"fail to parse http response: {e}")
    cntl._end_rpc(locked=True)


register_protocol(Protocol(
    name="http",
    type=ProtocolType.HTTP,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    # HTTP/1.1 answers in request order: each message of a read runs in
    # wire order in the reading task (ROADMAP queue C #14)
    process_inline=True,
    on_packed=on_packed,
))
