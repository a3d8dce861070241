"""nova_pbrpc, public_pbrpc and ubrpc — the pb-rpc variants riding nshead.

Port of brpc_tpu/rpc/legacy_nshead_family.py, byte-compatible with it.
As in the reference these are client protocols; a server answers them
through an ``NsheadService`` adaptor installed as
``ServerOptions.nshead_service``: ``NovaServiceAdaptor``,
``PublicPbrpcServiceAdaptor`` or ``UbrpcServiceAdaptor`` (one per port,
since a port has one nshead service).

Wire shapes:
  nova   — nshead + the message's bytes; the method's name rides
           ``provider`` (the adaptor dispatches by it) and its index
           ``reserved`` (``cntl.nova_method_index``, 0 by default); snappy
           is flagged by ``version`` 1; a failure comes back as its code
           in the head's ``id``;
  public — nshead + a ``PublicPbrpcRequest`` envelope
           (rpc/proto/legacy_meta.py) whose body carries the call's id,
           the service, the method's name in ``version`` and the request;
           the ``PublicPbrpcResponse`` carries the id back, so calls
           share a connection;
  ubrpc  — nshead + an mcpack object ``{method, params: [request]}``
           (mcpack2pb.py); the reply is ``{error_code, result}``.

nova and ubrpc frames carry no call id. The reference parks one call on
a socket and makes these channels pooled, failing a socket whose reply
is still owed; the port queues each call's attempt id under the
socket's write lock as nshead does (rpc/nshead_protocol.py), so calls
share a connection and replies go to them first in, first out (ROADMAP
queue C #30).

A server's adaptor resolves a method by the name the client sent, and
by index only when no name came (or nova's 16-byte ``provider`` cut it
short): the methods in name order, as in the reference. An unknown name
fails with ENOMETHOD. The adaptors run the service's handler directly,
as the reference's do: the call is not counted on ``/status``.
"""
from __future__ import annotations

import threading

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import compress as compress_mod
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller, lock_attempt
from brpc_tpu_torch.rpc.nshead_protocol import (
    NsheadInputMessage,
    NsheadMessage,
    NsheadService,
    next_attempt,
)
from brpc_tpu_torch.rpc.nshead_protocol import on_packed as queue_attempt
from brpc_tpu_torch.rpc.nshead_protocol import parse as nshead_parse
from brpc_tpu_torch.rpc.proto.legacy_meta import (
    PublicPbrpcRequest,
    PublicPbrpcResponse,
)
from brpc_tpu_torch.rpc.protocol import (
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

_NOVA_SNAPPY_VERSION = 1  # nshead.version of a snappy body


def _pb_serialize_request(request, cntl: Controller):
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    return request.SerializeToString()


def _client_parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    """nshead's framing, on client connections only (a server hears these
    protocols through its nshead service)."""
    if arg is not None:
        return ParseResult.try_others()
    res = nshead_parse(portal, sock, read_eof, arg)
    if res.status == ParseResult.OK:
        res.message.is_request = False
    return res


# -- nova_pbrpc ---------------------------------------------------------------

def _nova_pack_request(payload: bytes, cntl: Controller,
                       correlation_id: int) -> IOBuf:
    version = 0
    if cntl.compress_type == compress_mod.COMPRESS_SNAPPY:
        payload = compress_mod.compress(payload, cntl.compress_type)
        version = _NOVA_SNAPPY_VERSION
    _, _, method = cntl._method_full_name.rpartition(".")
    idx = getattr(cntl, "nova_method_index", None)
    msg = NsheadMessage(payload, version=version,
                        log_id=cntl.log_id & 0xFFFFFFFF,
                        provider=method.encode(),
                        reserved=idx if idx is not None else 0)
    return IOBuf(msg.serialize())


def _nova_process_response(msg: NsheadInputMessage):
    cid, cntl = next_attempt(msg.socket)
    if cntl is None:
        return
    if msg.msg.id:
        cntl.set_failed(msg.msg.id, "nova server error")
    else:
        try:
            body = msg.msg.body
            if msg.msg.version == _NOVA_SNAPPY_VERSION:
                body = compress_mod.decompress(body,
                                               compress_mod.COMPRESS_SNAPPY)
            resp = cntl._response
            if resp is not None and body:
                resp.ParseFromString(body)
        except Exception as e:
            cntl.set_failed(errors.ERESPONSE, f"fail to parse response: {e}")
    cntl._on_protocol_response(msg.socket, cid)


class NovaServiceAdaptor(NsheadService):
    """The server half: the method by the ``provider`` name (or by
    ``reserved`` as an index), the body a message, snappy by
    ``version``."""

    def __init__(self, service):
        self.service = service
        self._by_index = sorted(service.methods())

    def process_nshead_request(self, cntl, request: NsheadMessage, done):
        methods = self.service.methods()
        name = request.provider.rstrip(b"\x00").decode("utf-8", "replace")
        minfo = methods.get(name)
        if minfo is None:
            idx = request.reserved
            if 0 <= idx < len(self._by_index):
                cand = self._by_index[idx]
                if not name or (len(name) == 16 and cand.startswith(name)):
                    minfo = methods.get(cand)
        if minfo is None:
            done(NsheadMessage(b"", id_=errors.ENOMETHOD))
            return
        body = request.body
        if request.version == _NOVA_SNAPPY_VERSION:
            body = compress_mod.decompress(body, compress_mod.COMPRESS_SNAPPY)
        req = minfo.request_class()
        req.ParseFromString(body)
        resp = minfo.response_class()

        def inner_done():
            out = resp.SerializeToString()
            version = 0
            if request.version == _NOVA_SNAPPY_VERSION:
                out = compress_mod.compress(out, compress_mod.COMPRESS_SNAPPY)
                version = _NOVA_SNAPPY_VERSION
            done(NsheadMessage(out, version=version, log_id=request.log_id))

        minfo.handler(self.service, cntl, req, resp, inner_done)


register_protocol(Protocol(
    name="nova_pbrpc",
    type=ProtocolType.NOVA,
    parse=_client_parse,
    serialize_request=_pb_serialize_request,
    pack_request=_nova_pack_request,
    process_response=_nova_process_response,
    support_server=False,
    process_inline=True,
    on_packed=queue_attempt,
))


# -- public_pbrpc -------------------------------------------------------------

def _public_pack_request(payload: bytes, cntl: Controller,
                         correlation_id: int) -> IOBuf:
    env = PublicPbrpcRequest()
    env.requestHead.log_id = cntl.log_id & 0xFFFFFFFFFFFFFFFF
    env.requestHead.compress_type = 0
    body = env.requestBody.add()
    service, _, method = cntl._method_full_name.rpartition(".")
    body.service = service.rpartition(".")[2]
    body.method_id = 0
    body.version = method  # the name, for an adaptor of either package
    body.id = correlation_id
    body.serialized_request = payload
    msg = NsheadMessage(env.SerializeToString(),
                        log_id=cntl.log_id & 0xFFFFFFFF)
    return IOBuf(msg.serialize())


def _public_process_response(msg: NsheadInputMessage):
    env = PublicPbrpcResponse()
    try:
        env.ParseFromString(msg.msg.body)
    except ValueError:
        return
    for body in env.responseBody:
        cntl = lock_attempt(body.id)
        if cntl is None:
            continue
        if env.responseHead.code != 0 or body.error:
            cntl.set_failed(body.error or env.responseHead.code,
                            env.responseHead.text or "public_pbrpc error")
        else:
            resp = cntl._response
            try:
                if resp is not None and body.serialized_response:
                    resp.ParseFromString(body.serialized_response)
            except Exception as e:
                cntl.set_failed(errors.ERESPONSE,
                                f"fail to parse response: {e}")
        cntl._on_protocol_response(msg.socket, body.id)


class PublicPbrpcServiceAdaptor(NsheadService):
    """The server half: every body of the envelope is a call, answered in
    one ``PublicPbrpcResponse`` with the bodies' ids once all are done."""

    def __init__(self, service):
        self.service = service
        self._by_index = sorted(service.methods())

    def process_nshead_request(self, cntl, request: NsheadMessage, done):
        env = PublicPbrpcRequest()
        try:
            env.ParseFromString(request.body)
        except ValueError as e:
            done(NsheadMessage(f"bad envelope: {e}".encode()))
            return
        out = PublicPbrpcResponse()
        out.responseHead.code = 0
        methods = self.service.methods()
        lock = threading.Lock()
        pending = [len(env.requestBody)]

        def finish():
            done(NsheadMessage(out.SerializeToString(),
                               log_id=request.log_id))

        def dec() -> bool:
            with lock:
                pending[0] -= 1
                return pending[0] == 0

        if not env.requestBody:
            finish()
            return
        for body in env.requestBody:
            name = body.version or ""
            minfo = methods.get(name)
            if minfo is None and not name and 0 <= body.method_id < len(
                    self._by_index):
                minfo = methods.get(self._by_index[body.method_id])
            rb = out.responseBody.add()
            rb.id = body.id
            if minfo is None:
                rb.error = errors.ENOMETHOD
                if dec():
                    finish()
                continue
            req = minfo.request_class()
            try:
                req.ParseFromString(body.serialized_request)
            except ValueError:
                rb.error = errors.EREQUEST
                if dec():
                    finish()
                continue
            resp = minfo.response_class()

            def inner_done(rb=rb, resp=resp):
                rb.serialized_response = resp.SerializeToString()
                if dec():
                    finish()

            minfo.handler(self.service, cntl, req, resp, inner_done)


register_protocol(Protocol(
    name="public_pbrpc",
    type=ProtocolType.PUBLIC,
    parse=_client_parse,
    serialize_request=_pb_serialize_request,
    pack_request=_public_pack_request,
    process_response=_public_process_response,
    support_server=False,
    process_inline=True,
))


# -- ubrpc (over mcpack) ------------------------------------------------------

def _ubrpc_serialize_request(request, cntl: Controller):
    from brpc_tpu_torch.mcpack2pb import _pb_to_dict

    if isinstance(request, dict):
        return request
    return _pb_to_dict(request)


def _ubrpc_pack_request(req_obj: dict, cntl: Controller,
                        correlation_id: int) -> IOBuf:
    from brpc_tpu_torch import mcpack2pb as mp

    _, _, method = cntl._method_full_name.rpartition(".")
    obj = {"method": method, "params": [req_obj]}
    msg = NsheadMessage(mp.dumps(obj), log_id=cntl.log_id & 0xFFFFFFFF)
    return IOBuf(msg.serialize())


def _ubrpc_process_response(msg: NsheadInputMessage):
    from brpc_tpu_torch import mcpack2pb as mp
    from brpc_tpu_torch.mcpack2pb import _dict_to_pb

    cid, cntl = next_attempt(msg.socket)
    if cntl is None:
        return
    try:
        obj = mp.loads(msg.msg.body)
        err = obj.get("error_code", 0)
        if err:
            cntl.set_failed(int(err), str(obj.get("error_text", "ubrpc")))
        else:
            result = obj.get("result")
            resp = cntl._response
            if resp is not None and isinstance(result, dict):
                if isinstance(resp, dict):
                    resp.update(result)
                else:
                    _dict_to_pb(result, resp)
    except Exception as e:
        cntl.set_failed(errors.ERESPONSE, f"fail to parse response: {e}")
    cntl._on_protocol_response(msg.socket, cid)


class UbrpcServiceAdaptor(NsheadService):
    """The server half: the body an mcpack object with ``method`` and a
    ``params`` array; the reply ``{error_code, result}``."""

    def __init__(self, service):
        self.service = service

    def process_nshead_request(self, cntl, request: NsheadMessage, done):
        from brpc_tpu_torch import mcpack2pb as mp
        from brpc_tpu_torch.mcpack2pb import _dict_to_pb, _pb_to_dict

        try:
            obj = mp.loads(request.body)
            method = obj.get("method")
            if isinstance(method, bytes):
                method = method.decode()
            params = obj.get("params") or [{}]
        except Exception as e:
            done(NsheadMessage(mp.dumps(
                {"error_code": errors.EREQUEST,
                 "error_text": f"bad mcpack: {e}"})))
            return
        minfo = self.service.methods().get(method or "")
        if minfo is None:
            done(NsheadMessage(mp.dumps(
                {"error_code": errors.ENOMETHOD,
                 "error_text": f"unknown method {method!r}"})))
            return
        req = minfo.request_class()
        _dict_to_pb(params[0] if params else {}, req)
        resp = minfo.response_class()

        def inner_done():
            done(NsheadMessage(mp.dumps(
                {"error_code": 0, "result": _pb_to_dict(resp)}),
                log_id=request.log_id))

        minfo.handler(self.service, cntl, req, resp, inner_done)


register_protocol(Protocol(
    name="ubrpc",
    type=ProtocolType.UBRPC,
    parse=_client_parse,
    serialize_request=_ubrpc_serialize_request,
    pack_request=_ubrpc_pack_request,
    process_response=_ubrpc_process_response,
    support_server=False,
    process_inline=True,
    on_packed=queue_attempt,
))
