"""TLS and authentication of the port held against brpc_tpu's, on the CPU.

* ``HmacAuthenticator``: the same credential strings as the reference's
  for seeded secrets and users, each verifying the other's.
* Live over TLS (the test-only pair in brpc_tpu_torch/testdata), one port
  and one reference server in a module fixture, both with an
  ``HmacAuthenticator``: a tpu_std Echo that sees the caller's user, and
  a push and a pull of a seeded float32 tensor, port to reference,
  reference to port and port to port; EAUTH for a wrong secret and for
  no credential; a 300,000-byte echo; hulu's credential (ROADMAP queue C
  #28); the device handshake inside TLS, a pull's ACK authenticated
  too; 16 threads of 64 calls and two threads echoing 8 MiB twice each
  on one TLS connection, every reply its own, on sockets whose
  reads and writes take turns (#29); the console over HTTPS; gRPC over
  TLS.
* Refusals: a plaintext client to a TLS port fails at once and leaves no
  socket id behind; a TLS client to a plaintext port fails its handshake
  and never sends the call in plaintext.

Threads only; every wait has a deadline.
"""
import http.client
import os
import ssl
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc import authenticator as ref_auth
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import authenticator, errors
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc import socket as port_socket
from brpc_tpu_torch.rpc import tensor_service as ts
from brpc_tpu_torch.rpc.proto import wire

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "brpc_tpu_torch", "testdata")
CERT = os.path.join(TESTDATA, "tls_selfsigned_cert.pem")
KEY = os.path.join(TESTDATA, "tls_selfsigned_key.pem")
SECRET = b"tls-test-secret"
WAIT_MS = 5000
ECHO = "EchoService.Echo"


def _echo_of(pkg):
    req, resp = ((wire.EchoRequest, wire.EchoResponse) if pkg is rpc
                 else (echo_pb2.EchoRequest, echo_pb2.EchoResponse))

    class EchoService(pkg.Service):
        calls = 0

        @pkg.rpc_method(req, resp)
        def Echo(self, cntl, request, response, done):
            type(self).calls += 1
            ctx = cntl.auth_context
            response.message = (request.message if request.code
                                else f"{request.message}|"
                                     f"{ctx.user if ctx else '-'}")
            done()

    return EchoService()


@pytest.fixture(scope="module")
def servers():
    ref_get_task_control()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        port = rpc.Server(rpc.ServerOptions(
            num_threads=4, device="cpu", ssl_certfile=CERT, ssl_keyfile=KEY,
            auth=authenticator.HmacAuthenticator(SECRET)))
        port_echo = _echo_of(rpc)
        port.add_service(port_echo)
        port.add_service(ts.TensorStoreService())
        assert port.start("127.0.0.1:0") == 0
        ref = ref_rpc.Server(ref_rpc.ServerOptions(
            num_threads=4, has_builtin_services=False, ssl_certfile=CERT,
            ssl_keyfile=KEY, auth=ref_auth.HmacAuthenticator(SECRET)))
        ref.add_service(_echo_of(ref_rpc))
        ref.add_service(ref_ts.TensorStoreService())
        assert ref.start("127.0.0.1:0") == 0
        plain = rpc.Server(rpc.ServerOptions(num_threads=2, device="cpu",
                                             has_builtin_services=False))
        plain_echo = _echo_of(rpc)
        plain.add_service(plain_echo)
        assert plain.start("127.0.0.1:0") == 0
        yield {"port": port, "ref": ref, "plain": plain,
               "port_echo": port_echo, "plain_echo": plain_echo}
        plain.stop()
        ref.stop()
        port.stop()


def _auth(pkg, secret=SECRET, user="alice"):
    mod = authenticator if pkg is rpc else ref_auth
    return mod.HmacAuthenticator(secret, user=user)


def _channel(pkg, target, auth=None, **kw):
    opts = dict(use_ssl=True, timeout_ms=WAIT_MS, connect_timeout_ms=WAIT_MS,
                auth=auth)
    opts.update(kw)
    ch = pkg.Channel(pkg.ChannelOptions(**opts))
    assert ch.init(str(target)) == 0
    return ch


def _call(pkg, ch, message="hi", **kw):
    req, resp = ((wire.EchoRequest, wire.EchoResponse) if pkg is rpc
                 else (echo_pb2.EchoRequest, echo_pb2.EchoResponse))
    return ch.call(ECHO, req(message=message, **kw), resp)


def _x(seed=7, n=16 << 10):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def test_hmac_credentials_byte_equal():
    rng = np.random.default_rng(3)
    for _ in range(24):
        secret = rng.integers(0, 256, int(rng.integers(0, 40)),
                              dtype=np.uint8).tobytes()
        user = "".join(chr(int(c)) for c in rng.integers(97, 123, 6))
        ours = authenticator.HmacAuthenticator(secret, user=user)
        ref = ref_auth.HmacAuthenticator(secret, user=user)
        cred = ours.generate_credential(None)
        assert cred == ref.generate_credential(None)
        assert cred.startswith(f"{user}:") and len(cred) == len(user) + 65
        for verifier in (ours, ref):
            ok, ctx = verifier.verify_credential(cred, None)
            assert ok and ctx.user == user
            assert verifier.verify_credential(cred[:-1] + "0", None)[0] is (
                cred.endswith("0"))
            assert verifier.verify_credential("", None) == (False, None)


PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]


@pytest.mark.parametrize("client,server", PAIRS)
def test_echo_and_tensors_over_tls(servers, client, server):
    pkg = rpc if client == "port" else ref_rpc
    target = servers[server].listen_endpoint
    ch = _channel(pkg, target, _auth(pkg))
    try:
        cntl, resp = _call(pkg, ch, "tls")
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "tls|alice"
        x = _x()
        if pkg is rpc:
            client_ = ts.TensorClient(ch)
            cntl, presp = client_.push(f"t-{client}", [torch.from_numpy(x)])
            assert not cntl.failed() and presp.ok, cntl.error_text
            cntl, got = client_.pull(f"t-{client}", device="cpu")
        else:
            client_ = ref_ts.TensorClient(ch)
            cntl, presp = client_.push(f"t-{client}", [x])
            assert not cntl.failed() and presp.ok, cntl.error_text
            cntl, got = client_.pull(f"t-{client}")
        assert not cntl.failed(), cntl.error_text
        got = got[0].numpy() if isinstance(got[0], torch.Tensor) else got[0]
        assert np.asarray(got).tobytes() == x.tobytes()
        for auth in (_auth(pkg, b"wrong-secret"), None):
            bad = _channel(pkg, target, auth, max_retry=0)
            try:
                cntl, _ = _call(pkg, bad)
                assert cntl.error_code == errors.EAUTH, cntl.error_text
            finally:
                bad.close()
    finally:
        ch.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_large_echo_over_tls(servers, client, server):
    pkg = rpc if client == "port" else ref_rpc
    ch = _channel(pkg, servers[server].listen_endpoint, _auth(pkg))
    try:
        # a small call first: the reference's reading task and writer use
        # one TLS connection at once, and its big first write racing a
        # read can fail (ROADMAP queue C #29)
        assert not _call(pkg, ch)[0].failed()
        big = "s" * 300_000
        cntl, resp = _call(pkg, ch, big, code=1)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == big
    finally:
        ch.close()


def test_hulu_credential(servers):
    """ROADMAP queue C #28: the port's hulu carries the credential's UTF-8
    and verifies it; the reference's client cannot pack one, and its
    server refuses every one."""
    port = servers["port"].listen_endpoint
    for auth, want in ((_auth(rpc), 0), (_auth(rpc, b"wrong"), errors.EAUTH),
                       (None, errors.EAUTH)):
        ch = _channel(rpc, port, auth, protocol="hulu_pbrpc", max_retry=0)
        try:
            cntl, resp = _call(rpc, ch, "hulu")
            assert cntl.error_code == want, cntl.error_text
            if not want:
                assert resp.message == "hulu|alice"
        finally:
            ch.close()
    ch = _channel(rpc, servers["ref"].listen_endpoint, _auth(rpc),
                  protocol="hulu_pbrpc", max_retry=0)
    try:
        assert _call(rpc, ch)[0].error_code == errors.EAUTH
    finally:
        ch.close()
    ch = _channel(ref_rpc, port, _auth(ref_rpc), protocol="hulu_pbrpc",
                  max_retry=0)
    try:
        cntl, _ = _call(ref_rpc, ch)
        assert cntl.error_code == errors.EREQUEST
        assert "expected bytes, str found" in cntl.error_text
    finally:
        ch.close()


def test_device_handshake_inside_tls(servers):
    ch = _channel(rpc, servers["port"].listen_endpoint, _auth(rpc),
                  use_device_transport=True, device="cpu")
    try:
        client = ts.TensorClient(ch)
        x = torch.from_numpy(_x(11))
        cntl, presp = client.push("dev", [x])
        assert not cntl.failed() and presp.ok, cntl.error_text
        sock = cntl._current_sock
        assert isinstance(sock.fd(), port_socket.TLSSocket)
        assert sock.app_state.state == dt.ESTABLISHED
        cntl, got = client.pull("dev", device="cpu")
        assert not cntl.failed(), cntl.error_text
        assert torch.equal(got[0], x)
        # the pull's ACK carries the channel's credential: the server's
        # endpoint lets the send go
        mine = sock.fd().getsockname()[1]
        (conn,) = [c for c in servers["port"].list_connections()
                   if c.remote_side.port == mine]
        end = time.monotonic() + 3
        while conn.app_state.retained_count and time.monotonic() < end:
            time.sleep(0.01)
        assert conn.app_state.retained_count == 0
    finally:
        ch.close()


def test_many_threads_on_one_tls_connection(servers):
    """ROADMAP queue C #29: a reading task and writers share each TLS
    connection; the port's sockets take turns, so every reply reaches its
    own call."""
    srv = servers["port"]
    ch = _channel(rpc, srv.listen_endpoint, _auth(rpc), max_retry=0)
    bad, socks = [], set()

    def small(t):
        for j in range(64):
            m = f"t{t}-{j}" * (1 + j % 7)
            cntl, resp = _call(rpc, ch, m, code=1)
            socks.add(cntl._current_sock)
            if cntl.failed() or resp.message != m:
                bad.append((t, j, cntl.error_text))

    def big(k):
        m = chr(65 + k) * (8 << 20)
        for _ in range(2):
            cntl, resp = _call(rpc, ch, m, code=1)
            if cntl.failed() or resp.message != m:
                bad.append(("big", k, cntl.error_text))

    threads = ([threading.Thread(target=small, args=(t,)) for t in range(16)]
               + [threading.Thread(target=big, args=(k,)) for k in range(2)])
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert bad == []
        (sock,) = socks
        assert isinstance(sock.fd(), port_socket.TLSSocket)
        mine = sock.fd().getsockname()[1]
        (conn,) = [c for c in srv.list_connections()
                   if c.remote_side.port == mine]
        assert isinstance(conn.fd(), port_socket.TLSSocket)
    finally:
        ch.close()


def _accepted_sockets() -> set:
    """The ids of the server-side sockets alive in this process."""
    reg = port_socket._registry
    with reg._lock:
        return {s.socket_id for _, s in reg._slots
                if s is not None and s._accepted}


def test_plaintext_client_refused(servers):
    srv = servers["port"]
    before = _accepted_sockets()
    calls = servers["port_echo"].calls
    ch = rpc.Channel(rpc.ChannelOptions(auth=_auth(rpc), timeout_ms=2000,
                                        max_retry=0))
    assert ch.init(str(srv.listen_endpoint)) == 0
    t0 = time.monotonic()
    cntl, _ = _call(rpc, ch)
    assert cntl.failed() and time.monotonic() - t0 < 1.5, cntl.error_text
    ch.close()
    time.sleep(0.1)  # the server's handshake task has given up by now
    assert _accepted_sockets() <= before
    assert servers["port_echo"].calls == calls
    # the port answers TLS at once after it
    ch = _channel(rpc, srv.listen_endpoint, _auth(rpc))
    try:
        assert _call(rpc, ch)[1].message == "hi|alice"
    finally:
        ch.close()


@pytest.mark.parametrize("pkg_name", ["port", "ref"])
def test_tls_client_to_plaintext_port_fails(servers, pkg_name):
    pkg = rpc if pkg_name == "port" else ref_rpc
    calls = servers["plain_echo"].calls
    ch = _channel(pkg, servers["plain"].listen_endpoint, None, max_retry=0,
                  connect_timeout_ms=500, timeout_ms=2000)
    try:
        cntl, _ = _call(pkg, ch)
        assert cntl.failed()
    finally:
        ch.close()
    assert servers["plain_echo"].calls == calls  # nothing in plaintext


def _https_get(port: int, path: str) -> bytes:
    ctx = ssl.create_default_context(cafile=CERT)
    conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=5,
                                       context=ctx)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        assert resp.status == 200
        return resp.read()
    finally:
        conn.close()


def _status_count(page: bytes, method: str) -> int:
    for line in page.split(b"\n"):
        if line.startswith(method.encode() + b": "):
            return int(line.split(b" count=")[1].split()[0])
    return 0


def test_console_over_https(servers):
    srv = servers["port"]
    port = srv.listen_endpoint.port
    before = _status_count(_https_get(port, "/status"), ECHO)
    ch = _channel(rpc, srv.listen_endpoint, _auth(rpc))
    try:
        for i in range(5):
            assert not _call(rpc, ch, f"c{i}")[0].failed()
    finally:
        ch.close()
    assert _status_count(_https_get(port, "/status"), ECHO) == before + 5
    assert b"EchoService_Echo_count : " in _https_get(port, "/vars")


def test_grpc_over_tls(servers):
    ch = _channel(rpc, servers["port"].listen_endpoint, protocol="h2:grpc")
    try:
        cntl, resp = _call(rpc, ch, "grpc", code=1)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "grpc"
        assert isinstance(cntl._current_sock.fd(), port_socket.TLSSocket)
    finally:
        ch.close()
