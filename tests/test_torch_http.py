"""The port's HTTP protocol and json2pb held against brpc_tpu's, on the CPU.

* json2pb: every message of the port's codec against the reference's
  generated message, both ways, on a seeded corpus (int64 as a string,
  out-of-range ints, unknown keys, wrong types, nested and repeated
  messages, null, both printing options): the same JSON text, the same
  parsed bytes, the same failures.
* http_message: ``try_parse`` cut at every offset of a corpus (GET, POST
  with Content-Length, chunked, query strings, a response, bad heads)
  gives the same states and fields; ``serialize`` is byte-equal.
* One Echo server per package (a module fixture): the same request bytes
  give the same answer bytes (status, ``x-error-code``, body) for Echo as
  JSON and as proto, a restful mapping, the bad-method pages, an unknown
  page, HEAD, a malformed body (400, counted as EREQUEST) and a limit of
  one (503, ELIMIT).
* Clients both ways: a port ``Channel(protocol="http")`` to each server
  and a reference one to the port server, 16 calls at once on one
  connection.
* Faults of the reference the port does not copy (ROADMAP queue C #14,
  #15): pipelined requests and responses read together run in parallel
  tasks (answered out of order, matched to the wrong calls); bodies past
  64 KiB are cut short; a head with an unparsable number raises.
* A keep-alive server that starts answering ``Connection: close`` marks
  its connection lame duck in both packages; one that closes after every
  answer does not.

Threads only, no spawned process; every wait has a deadline.
"""
import json
import socket as pysocket
import threading
import time

import numpy as np
import pytest

from brpc_tpu import json2pb as ref_j2p
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import http_message as ref_hm
from brpc_tpu.rpc import http_protocol as ref_hp
from brpc_tpu.rpc import input_messenger as ref_im
from brpc_tpu.rpc.proto import echo_pb2, rpc_meta_pb2, tensor_service_pb2
from brpc_tpu_torch import json2pb, rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import http_message as hm
from brpc_tpu_torch.rpc import http_protocol as hp
from brpc_tpu_torch.rpc import input_messenger as port_im
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 3.0

# -- json2pb -----------------------------------------------------------------

_REF_MODULES = (echo_pb2, rpc_meta_pb2, tensor_service_pb2)
MESSAGES = sorted(n for n in dir(wire)
                  if isinstance(getattr(wire, n), type)
                  and issubclass(getattr(wire, n), wire.Message)
                  and getattr(wire, n) is not wire.Message)


def _ref_class(name: str):
    for mod in _REF_MODULES:
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


# values a field may meet: ints at and past the int32/int64 edges, int64
# as decimal strings (and strings that are not), floats, bools, null,
# the wrong containers
_VALUES = [0, 1, -1, 2**31 - 1, 2**31, -2**31 - 1, 2**63 - 1, 2**63, -2**63,
           "12", "-9223372036854775808", "9223372036854775808", "0x10", " 7",
           "abc", 1.0, 1.5, True, False, "true", "False", None, [], {},
           "héllo", "", [1, "2"], 3e20]
_PRINT_OPTIONS = [{}, {"jsonify_empty_array": True},
                  {"always_print_primitive_fields": True},
                  {"jsonify_empty_array": True,
                   "always_print_primitive_fields": True}]


def _random_doc(cls, rng, depth=0) -> dict:
    doc = {}
    for _, name, kind, sub in cls.FIELDS:
        if rng.random() < 0.3:
            continue
        key = name if rng.random() < 0.7 else json2pb._json_name(name)
        if kind == wire.MESSAGE and depth < 2 and rng.random() < 0.8:
            doc[key] = _random_doc(sub, rng, depth + 1)
        elif kind == wire.REPEATED_MESSAGE and depth < 2 and rng.random() < 0.8:
            doc[key] = [_random_doc(sub, rng, depth + 1)
                        for _ in range(int(rng.integers(0, 3)))]
        elif kind == wire.PACKED_INT64 and rng.random() < 0.7:
            doc[key] = [_VALUES[int(rng.integers(0, 12))]
                        for _ in range(int(rng.integers(0, 4)))]
        else:
            doc[key] = _VALUES[int(rng.integers(0, len(_VALUES)))]
    if rng.random() < 0.2:
        doc["not_a_field"] = {"x": 1}
    return doc


def _both_parse(text: str, name: str):
    """(reference result, port result): the parsed message or the
    failure's text."""
    out = []
    for mod, cls in ((ref_j2p, _ref_class(name)), (json2pb, getattr(wire, name))):
        try:
            out.append(mod.json_to_pb(text, cls))
        except mod.ParseError as e:
            out.append(f"ParseError: {e}")
    return out


def _assert_same(ref, port):
    if isinstance(ref, str) or isinstance(port, str):
        assert ref == port
        return
    assert ref.SerializeToString() == port.SerializeToString()
    for opts in _PRINT_OPTIONS:
        assert (ref_j2p.pb_to_json(ref, ref_j2p.Pb2JsonOptions(**opts))
                == json2pb.pb_to_json(port, json2pb.Pb2JsonOptions(**opts)))


@pytest.mark.parametrize("name", MESSAGES)
def test_json2pb_corpus_matches_reference(name):
    ref_cls, cls = _ref_class(name), getattr(wire, name)
    assert [f.name for f in ref_cls.DESCRIPTOR.fields] == [
        f[1] for f in cls.FIELDS]
    assert cls.FULL_NAME == ref_cls.DESCRIPTOR.full_name
    assert cls.PROTO_FILE == ref_cls.DESCRIPTOR.file.name
    rng = np.random.default_rng(MESSAGES.index(name))
    parsed = 0
    for _ in range(120):
        ref, port = _both_parse(json.dumps(_random_doc(cls, rng)), name)
        _assert_same(ref, port)
        parsed += not isinstance(ref, str)
    assert parsed > 0  # the corpus reaches both outcomes
    # the empty message, with and without the options
    _assert_same(ref_cls(), cls())


_NAMED = [
    ("TensorPushResponse", '{"ack_seq": "9223372036854775807", "ok": true}'),
    ("TensorPushResponse", '{"ack_seq": "9223372036854775808"}'),
    ("TensorPushResponse", '{"ackSeq": -9223372036854775809}'),
    ("EchoRequest", '{"sleep_us": 2147483648}'),
    ("EchoRequest", '{"sleep_us": "12", "code": 3.0, "message": "m"}'),
    ("EchoRequest", '{"sleep_us": 1.5}'),
    ("EchoRequest", '{"message": 5}'),
    ("EchoRequest", '{"message": "\\ud800"}'),
    ("TensorPullResponse", '{"found": "yes"}'),
    ("TensorPullResponse", '{"found": 1, "unknown": [1, 2]}'),
    ("RpcMeta", '{"request": {"service_name": "S", "log_id": "7"}, '
                '"tensors": [{"shape": [1, "2"], "dtype": "f32"}, {}]}'),
    ("RpcMeta", '{"tensors": {"shape": []}}'),
    ("RpcMeta", '{"request": []}'),
    ("RpcMeta", '{"tensors": [{"shape": [true]}]}'),
    ("RpcMeta", '{"response": {"errorCode": 5, "error_text": null}}'),
    ("RpcMeta", '[1, 2]'),
    ("RpcMeta", '{"request": '),
]


@pytest.mark.parametrize("name,text", _NAMED,
                         ids=[f"{i}-{n}" for i, (n, _) in enumerate(_NAMED)])
def test_json2pb_named_cases(name, text):
    ref, port = _both_parse(text, name)
    _assert_same(ref, port)
    ok = [m.json_to_pb_inplace(text, c()) for m, c in (
        (ref_j2p, _ref_class(name)), (json2pb, getattr(wire, name)))]
    assert ok[0] == ok[1] == (not isinstance(ref, str))


# -- http_message ------------------------------------------------------------

_CHUNKED = (b"POST /EchoService/Echo HTTP/1.1\r\nTransfer-Encoding: chunked"
            b"\r\nContent-Type: application/json\r\n\r\n"
            b"7;ext=1\r\n{\"messa\r\n0a\r\nge\": \"hi\"}\r\n0\r\n\r\n")
PARSE_CORPUS = {
    "get": b"GET /status HTTP/1.1\r\nHost: h\r\n\r\n",
    "get_query": (b"GET /vars/x?chart=1&a+b=c%20d&flag&=v HTTP/1.1\r\n"
                  b"Accept:  */*  \r\nX-Odd:a:b\r\n\r\n"),
    "post": (b"POST /EchoService/Echo HTTP/1.1\r\nContent-Length: 19\r\n"
             b"Content-Type: application/json\r\n\r\n{\"message\": \"abc\"}x"),
    "chunked": _CHUNKED,
    "response": (b"HTTP/1.1 503 Service Unavailable\r\nRetry-After: 3\r\n"
                 b"Content-Length: 4\r\n\r\nbusy"),
    "head_no_body": b"HEAD / HTTP/1.0\r\nConnection: close\r\n\r\n",
    "bad_request_line": b"GET /only-two\r\nHost: h\r\n\r\n",
    "not_http": b"XYZW something else\r\n\r\n",
    "trace_prefix": b"TRACE / HTTP/1.1\r\n\r\n",
}


def _fields(msg):
    if msg is None:
        return None
    common = (type(msg).__name__, msg.version, sorted(msg.headers.items()),
              msg.body.to_bytes())
    if type(msg).__name__ == "HttpRequest":
        return common + (msg.method, msg.uri, msg.path, msg.query)
    return common + (msg.status_code, msg.reason)


@pytest.mark.parametrize("case", sorted(PARSE_CORPUS))
def test_try_parse_at_every_cut(case):
    raw = PARSE_CORPUS[case]
    for k in range(1, len(raw) + 1):
        got = []
        for mod, buf in ((ref_hm, RefIOBuf()), (hm, IOBuf())):
            buf.append(raw[:k])
            state, msg = mod.try_parse(buf)
            got.append((state, _fields(msg), len(buf)))
        assert got[0] == got[1], (k, got)
    # pipelined: the message and the start of the next leave the same rest
    rests = []
    for mod, buf in ((ref_hm, RefIOBuf()), (hm, IOBuf())):
        buf.append(raw + b"GET /next HTTP/1.1\r\n")
        rests.append((mod.try_parse(buf)[0], buf.to_bytes()))
    assert rests[0] == rests[1]


def test_oversized_head_is_an_error():
    raw = b"GET / HTTP/1.1\r\nX-Big: " + b"a" * (hm.MAX_HEADER_BYTES + 10)
    for mod, buf in ((ref_hm, RefIOBuf()), (hm, IOBuf())):
        buf.append(raw)
        assert mod.try_parse(buf) == ("error", None)


def _build(mod, kind):
    if kind == "get":
        m = mod.HttpRequest("GET", "/status?x=1")
        m.headers.set("Host", "h:1")
    elif kind in ("post", "put_empty"):
        m = mod.HttpRequest("POST" if kind == "post" else "PUT", "/S/M")
        if kind == "post":
            m.body.append(b'{"message": "x"}')
        m.headers.set("Content-Type", "application/json")
        m.headers.set("x-correlation-id", 77)
    else:
        m = mod.HttpResponse(404, "Not Found")
        m.set_body("no such page\n")
        m.headers.set("X-Error-Code", 1002)
    return m


@pytest.mark.parametrize("kind", ["get", "post", "put_empty", "response"])
def test_serialize_is_byte_equal(kind):
    assert (_build(ref_hm, kind).serialize().to_bytes()
            == _build(hm, kind).serialize().to_bytes())


def test_body_past_64KiB_is_read_whole():
    """Reference queue C #15: brpc_tpu/rpc/http_message.py:try_parse reads
    the body from its 64 KiB header scan, so a longer body comes out cut
    short; the port's is whole."""
    body = json.dumps({"message": "m" * (100 << 10)}).encode()
    raw = (b"POST /EchoService/Echo HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
           % len(body)) + body
    got = []
    for mod, buf in ((ref_hm, RefIOBuf()), (hm, IOBuf())):
        buf.append(raw)
        state, msg = mod.try_parse(buf)
        got.append((state, len(msg.body), len(buf)))
    assert got[1] == ("ok", len(body), 0)
    assert got[0][0] == "ok" and got[0][1] < len(body)  # the reference's fault


@pytest.mark.parametrize("raw", [
    b"POST /S/M HTTP/1.1\r\nContent-Length: abc\r\n\r\n",
    b"HTTP/1.1 OK fine\r\nContent-Length: 0\r\n\r\n",
], ids=["content_length", "status_code"])
def test_unparsable_number_in_the_head_is_an_error(raw):
    """Reference queue C #15: brpc_tpu/rpc/http_message.py:try_parse raises
    ValueError on a head whose Content-Length or status code is not a
    number (its messenger then leaves the bytes in the portal); the port
    answers "error", and its messenger closes the connection."""
    ref, port = RefIOBuf(), IOBuf()
    ref.append(raw)
    port.append(raw)
    with pytest.raises(ValueError):
        ref_hm.try_parse(ref)
    assert hm.try_parse(port) == ("error", None)


# -- the same request bytes to both servers ------------------------------------

def _echo_service(mod, msgs, gate):
    class Echo(mod.Service):
        SERVICE_NAME = "EchoService"

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            if request.code:
                cntl.set_failed(request.code, "requested failure")
                done()
                return
            response.message = request.message
            done()

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Hold(self, cntl, request, response, done):
            """Limited to one call at a time; waits for the gate."""
            gate.wait(WAIT_S)
            response.message = request.message
            done()

    return Echo()


PKGS = {"ref": (ref_rpc, echo_pb2), "port": (rpc, wire)}


@pytest.fixture(scope="module")
def servers():
    """An Echo server per package, with the console, a restful mapping and
    a limit of one on EchoService.Hold."""
    gate = threading.Event()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        ref_get_task_control()  # the bthread pool's first sizing sticks
        out = {}
        try:
            for pkg, (mod, msgs) in PKGS.items():
                kw = {"device": "cpu"} if pkg == "port" else {"num_threads": 4}
                srv = mod.Server(mod.ServerOptions(
                    restful_mappings="/v1/echo => EchoService.Echo",
                    method_max_concurrency={"EchoService.Hold": 1}, **kw))
                assert srv.add_service(_echo_service(mod, msgs, gate)) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg] = srv
            yield out, gate
        finally:
            for srv in out.values():
                srv.stop()


def _request(method, uri, body=b"", ctype=None, close=True):
    head = f"{method} {uri} HTTP/1.1\r\nHost: test\r\n"
    if ctype:
        head += f"Content-Type: {ctype}\r\n"
    if body or method == "POST":
        head += f"Content-Length: {len(body)}\r\n"
    if close:
        head += "Connection: close\r\n"
    return head.encode() + b"\r\n" + body


def _read_all(conn) -> bytes:
    conn.settimeout(WAIT_S)
    out = b""
    while True:
        data = conn.recv(65536)
        if not data:
            return out
        out += data


def _exchange(srv, raw: bytes) -> bytes:
    with pysocket.create_connection(
            ("127.0.0.1", srv.listen_endpoint.port), WAIT_S) as conn:
        conn.sendall(raw)
        return _read_all(conn)


_echo_pb = wire.EchoRequest(message="pb", code=0).SerializeToString()
EXCHANGES = {
    "json": _request("POST", "/EchoService/Echo", b'{"message": "hi"}',
                     "application/json"),
    "json_failure": _request("POST", "/EchoService/Echo",
                             b'{"message": "x", "code": 1004}'),
    "proto": _request("POST", "/EchoService/Echo", _echo_pb,
                      "application/proto"),
    "query": _request("GET", "/EchoService/Echo?message=q&sleep_us=3"),
    "restful": _request("POST", "/v1/echo", b'{"message": "rest"}'),
    "restful_failure": _request("POST", "/v1/echo", b'{"code": 2004}'),
    "missing_method": _request("GET", "/EchoService"),
    "bad_method": _request("GET", "/EchoService/Nope"),
    "unknown_page": _request("GET", "/no/such/page"),
    "head": _request("HEAD", "/EchoService/Echo?message=h"),
    "malformed_json": _request("POST", "/EchoService/Echo", b'{"message": '),
    "wrong_type": _request("POST", "/EchoService/Echo", b'{"code": "x"}'),
    "malformed_proto": _request("POST", "/EchoService/Echo", b"\x0a\x05ab",
                                "application/proto"),
}


@pytest.mark.parametrize("case", sorted(EXCHANGES))
def test_same_bytes_same_answer(servers, case):
    srvs, _ = servers
    counts = {pkg: srv.method_statuses()["EchoService.Echo"]
              .latency_recorder.count() for pkg, srv in srvs.items()}
    got = {pkg: _exchange(srv, EXCHANGES[case]) for pkg, srv in srvs.items()}
    assert got["port"] == got["ref"]
    assert got["port"].startswith(b"HTTP/1.1 ")
    deltas = {pkg: srv.method_statuses()["EchoService.Echo"]
              .latency_recorder.count() - counts[pkg]
              for pkg, srv in srvs.items()}
    assert deltas["port"] == deltas["ref"]
    if case.startswith("malformed"):
        # refused before the handler, and counted in the method's status
        assert b" 400 Bad Request\r\n" in got["port"] and deltas["port"] == 1
    if case == "head":
        assert got["port"].endswith(b"\r\n\r\n")  # no body


def test_limit_of_one_answers_503_elimit(servers):
    srvs, gate = servers
    gate.clear()
    answers = {}
    try:
        for pkg, srv in srvs.items():
            held = pysocket.create_connection(
                ("127.0.0.1", srv.listen_endpoint.port), WAIT_S)
            held.sendall(_request("POST", "/EchoService/Hold",
                                  b'{"message": "held"}'))
            status = srv.method_statuses()["EchoService.Hold"]
            deadline = time.monotonic() + WAIT_S
            while status.concurrency < 1 and time.monotonic() < deadline:
                time.sleep(0.002)
            refused = _exchange(srv, _request("POST", "/EchoService/Hold",
                                              b'{"message": "second"}'))
            answers[pkg] = (refused, status.rejected_count, held)
        gate.set()
        for pkg, (refused, rejected, held) in answers.items():
            with held:
                assert _read_all(held).endswith(b'{"message": "held"}')
            answers[pkg] = (refused, rejected)
    finally:
        gate.set()
    assert answers["port"] == answers["ref"]
    assert answers["port"][0].startswith(b"HTTP/1.1 503 Service Unavailable")
    assert answers["port"][0].endswith(b"reached max_concurrency")
    assert answers["port"][1] == 1


# -- pipelining: a fault of the reference (ROADMAP queue C #14) ---------------

class _StubSocket:
    """What the messenger and the HTTP protocol touch of a server's
    connection: the read portal, the matched protocol and the writes."""

    def __init__(self, portal):
        self.read_portal = portal
        self.matched_protocol = None
        self.remote_side = "127.0.0.1:1"
        self.writes = []
        self.failure = None

    def write(self, buf, **kw):
        self.writes.append(buf.to_bytes())
        return 0

    def set_failed(self, code=0, text="", **kw):
        self.failure = code

    def failed(self):
        return self.failure is not None


def test_pipelined_requests_are_answered_in_order(servers, monkeypatch):
    """Three requests in one read: the port answers them in order; the
    reference runs all but the last in tasks of their own (held here
    until the read is done), so it answers the last first."""
    srvs, _ = servers
    raw = b"".join(_request("POST", "/EchoService/Echo",
                            b'{"message": "%d"}' % i, close=False)
                   for i in (1, 2, 3))
    order = {}
    for pkg, mod, im, buf in (("ref", ref_rpc, ref_im, RefIOBuf()),
                              ("port", rpc, port_im, IOBuf())):
        later = []
        monkeypatch.setattr(im, "start_background",
                            lambda fn, *a: later.append((fn, a)))
        srv = srvs[pkg]
        buf.append(raw)
        sock = _StubSocket(buf)
        srv._messenger._cut_and_process(sock, read_eof=False)
        for fn, a in later:
            fn(*a)
        order[pkg] = [w.rsplit(b'"message": "', 1)[1][:1] for w in sock.writes]
    assert order["port"] == [b"1", b"2", b"3"]
    assert order["ref"] == [b"3", b"1", b"2"]  # the reference's fault


def _answer_two_at_once(bodies):
    """A one-connection HTTP server thread: reads two requests, then
    writes both answers in one segment."""
    lsock = pysocket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(WAIT_S)

    def serve():
        conn, _ = lsock.accept()
        conn.settimeout(WAIT_S)
        data = b""
        while data.count(b"\r\n\r\n") < 2 or not data.endswith(b"}"):
            chunk = conn.recv(4096)
            if not chunk:
                return
            data += chunk
        conn.sendall(b"".join(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n%s" % (len(b), b) for b in bodies))
        time.sleep(0.3)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lsock, t


def test_responses_read_together_reach_their_calls(monkeypatch):
    """Two answers in one read: the port gives each call its own; the
    reference, whose first answer waits in a task of its own (held here
    until the read is done), gives the second call's answer to the
    first."""
    got = {}
    for pkg, mod, msgs, im in (("ref", ref_rpc, echo_pb2, ref_im),
                               ("port", rpc, wire, port_im)):
        real_start = im.start_background
        monkeypatch.setattr(im, "start_background", lambda fn, *a: real_start(
            lambda: (time.sleep(0.2), fn(*a))))
        lsock, t = _answer_two_at_once([b'{"message": "first"}',
                                        b'{"message": "second"}'])
        ch = mod.Channel(mod.ChannelOptions(protocol="http", max_retry=0))
        assert ch.init(f"127.0.0.1:{lsock.getsockname()[1]}") == 0
        ends, out = threading.Event(), {}
        for tag in ("first", "second"):
            cntl, resp = mod.Controller(), msgs.EchoResponse()
            cntl.timeout_ms = WAIT_S * 1000

            def done(c, tag=tag, resp=resp):
                out[tag] = (c.error_code, resp.message)
                if len(out) == 2:
                    ends.set()
            ch.call_method("EchoService.Echo", cntl,
                           msgs.EchoRequest(message=tag), resp, done)
        assert ends.wait(WAIT_S)
        t.join(WAIT_S)
        lsock.close()
        ch.close()
        got[pkg] = out
        monkeypatch.undo()
    assert got["port"] == {"first": (0, "first"), "second": (0, "second")}
    assert got["ref"] == {"first": (0, "second"), "second": (0, "first")}


# -- clients both ways -------------------------------------------------------

def _sixteen_at_once(mod, msgs, srv):
    """16 calls at once through one HTTP channel (one connection):
    {message sent: (error code, message answered)}."""
    ch = mod.Channel(mod.ChannelOptions(protocol="http", max_retry=0))
    assert ch.init(str(srv.listen_endpoint)) == 0
    out, ends, lock = {}, threading.Event(), threading.Lock()
    try:
        for i in range(16):
            cntl, resp = mod.Controller(), msgs.EchoResponse()
            cntl.timeout_ms = WAIT_S * 1000

            def done(c, i=i, resp=resp):
                with lock:
                    out[str(i)] = (c.error_code, resp.message)
                    if len(out) == 16:
                        ends.set()
            ch.call_method("EchoService.Echo", cntl,
                           msgs.EchoRequest(message=str(i)), resp, done)
        assert ends.wait(WAIT_S)
        return out
    finally:
        ch.close()


def test_sixteen_calls_on_one_connection(servers):
    srvs, _ = servers
    conns = srvs["port"].connection_count()
    own = {str(i): (0, str(i)) for i in range(16)}
    # the port on both ends: every call gets its own answer
    assert _sixteen_at_once(rpc, wire, srvs["port"]) == own
    # with the reference at either end, every call completes with one of
    # the answers; which call gets which is up to the reference's tasks
    # (ROADMAP queue C #14)
    for got in (_sixteen_at_once(rpc, wire, srvs["ref"]),
                _sixteen_at_once(ref_rpc, echo_pb2, srvs["port"])):
        assert sorted(got) == sorted(own)
        assert sorted(got.values()) == sorted(own.values())
    deadline = time.monotonic() + WAIT_S
    while (srvs["port"].connection_count() > conns
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert srvs["port"].connection_count() <= conns


def test_http_channel_failures_match(servers):
    srvs, _ = servers
    got = {}
    for cpkg, (mod, msgs) in PKGS.items():
        for spkg, srv in srvs.items():
            ch = mod.Channel(mod.ChannelOptions(protocol="http", max_retry=0))
            assert ch.init(str(srv.listen_endpoint)) == 0
            try:
                row = []
                for method, req in (
                        ("EchoService.Echo", msgs.EchoRequest(message="a")),
                        ("EchoService.Echo", msgs.EchoRequest(code=1004)),
                        ("EchoService.Nope", msgs.EchoRequest()),
                        ("Nope.Echo", msgs.EchoRequest())):
                    cntl, resp = ch.call(method, req, msgs.EchoResponse,
                                         timeout_ms=WAIT_S * 1000)
                    row.append((cntl.error_code, cntl.error_text[:40],
                                resp.message))
                got[cpkg, spkg] = row
            finally:
                ch.close()
    rows = list(got.values())
    assert all(r == rows[0] for r in rows), got
    assert [r[0] for r in rows[0]] == [0, errors.EAUTH, errors.EHTTP,
                                       errors.EHTTP]


# -- lame duck ----------------------------------------------------------------

class _ClientSocket:
    def __init__(self):
        self.lame_duck = False

    def mark_lame_duck(self):
        self.lame_duck = True


@pytest.mark.parametrize("sequence,marked", [
    (["keep-alive", "close"], True),
    (["close", "close"], False),
    (["keep-alive", "keep-alive"], False),
], ids=["keep_alive_then_close", "close_per_response", "keep_alive"])
def test_lame_duck_on_the_close_transition(sequence, marked):
    for mod, msgs in ((ref_hp, ref_hm), (hp, hm)):
        sock = _ClientSocket()
        for conn in sequence:
            resp = msgs.HttpResponse(200, "OK")
            resp.headers.set("Connection", conn)
            msg = mod.HttpInputMessage(resp)
            msg.socket = sock
            mod.process_response(msg)  # no call waits: only the marking
        assert sock.lame_duck is marked, mod.__name__
