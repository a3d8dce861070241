"""The port's recordio and rpc_dump held against brpc_tpu's, on the CPU,
with threads.

* recordio: the same records give byte-equal files in both packages,
  each package reads the other's, and both stop at a tail cut short and
  refuse a bad checksum alike.
* rpc_dump: with ``rpc_dump_sample_every`` 3, nine calls record the same
  three requests in both packages.
* A dumped ``TensorStore.Push`` holds the few bytes of its request
  message and none of its tensors, so its replay fails with 1003
  "no tensors in request", in both packages (ROADMAP queue C #16).
* ``/rpc_dump`` and ``/rpc_dump?seconds=1`` give the reference's page.

The flags are restored and the dump files closed in ``finally``.
"""
import glob
import http.client
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.butil import recordio as ref_recordio
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc import rpc_dump as ref_dump
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags, recordio
from brpc_tpu_torch.rpc import errors, rpc_dump
from brpc_tpu_torch.rpc import tensor_service as port_ts
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 10.0  # a deadline under load, never a sleep
PKGS = {"port": (rpc, wire, flags, rpc_dump, recordio, port_ts),
        "ref": (ref_rpc, echo_pb2, ref_flags, ref_dump, ref_recordio, ref_ts)}
RECORDS = [({"service": "EchoService", "method": "Echo", "log_id": 7,
             "ts": 1700000000.25}, b"\n\x05hello"),
           ({"lane": "echo", "nested": {"k": [1, 2.5, None, True]}}, b""),
           ({}, bytes(range(256)) * 40)]


def test_recordio_files_are_byte_equal_and_cross_read(tmp_path):
    paths = {}
    for pkg, mods in PKGS.items():
        paths[pkg] = str(tmp_path / f"{pkg}.rio")
        with mods[4].RecordWriter(paths[pkg]) as w:
            for meta, payload in RECORDS:
                w.write(meta, payload)
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    for pkg, other in (("port", "ref"), ("ref", "port")):
        with PKGS[pkg][4].RecordReader(paths[other]) as r:
            assert list(r) == RECORDS


@pytest.mark.parametrize("damage", ["cut_tail", "bad_crc"])
def test_recordio_damaged_files_alike(tmp_path, damage):
    path = tmp_path / "damaged.rio"
    with recordio.RecordWriter(str(path)) as w:
        for meta, payload in RECORDS:
            w.write(meta, payload)
    data = bytearray(path.read_bytes())
    if damage == "cut_tail":
        data = data[:-10]
    else:
        data[30] ^= 0xFF  # inside the first record's meta
    path.write_bytes(bytes(data))
    for mod in (recordio, ref_recordio):
        with mod.RecordReader(str(path)) as r:
            if damage == "cut_tail":
                assert list(r) == RECORDS[:2]
            else:
                with pytest.raises(ValueError, match="crc mismatch"):
                    list(r)


def _echo(mod, msgs):
    class EchoService(mod.Service):
        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

    return EchoService()


@pytest.fixture(scope="module")
def servers():
    """Per package: a server with the console, an echo and a store."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        # the reference's native pieces would build its native runtime
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        ref_get_task_control()  # the bthread pool's first sizing sticks
        out = {}
        try:
            for pkg, (mod, msgs, _, _, _, ts) in PKGS.items():
                kw = {"device": "cpu"} if pkg == "port" else {"num_threads": 4}
                srv = mod.Server(mod.ServerOptions(**kw))
                for svc in (_echo(mod, msgs), ts.TensorStoreService()):
                    assert srv.add_service(svc) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg] = srv
            yield out
        finally:
            for srv in out.values():
                srv.stop()


class Dumping:
    """rpc_dump on under ``directory`` for one package; restored after."""

    def __init__(self, pkg: str, directory, every: int = 1):
        _, _, self.fl, self.dump, self.rio, _ = PKGS[pkg]
        self.directory, self.every = str(directory), every

    def __enter__(self):
        self.dump.reset_for_tests()
        assert self.fl.set_flag("rpc_dump_dir", self.directory)
        assert self.fl.set_flag("rpc_dump_sample_every", self.every)
        assert self.fl.set_flag("rpc_dump", True)
        return self

    def __exit__(self, *exc):
        self.fl.set_flag("rpc_dump", False)
        self.fl.set_flag("rpc_dump_sample_every", 1)
        self.fl.set_flag("rpc_dump_dir", "./rpc_dump")
        self.dump.reset_for_tests()

    def records(self, reader_mod=None):
        out = []
        for path in sorted(glob.glob(os.path.join(self.directory, "*.rio"))):
            with (reader_mod or self.rio).RecordReader(path) as r:
                out.extend(r)
        return out


def test_dump_samples_one_in_n_alike(servers, tmp_path):
    got = {}
    for pkg, (mod, msgs, *_) in PKGS.items():
        ch = mod.Channel()
        assert ch.init(str(servers[pkg].listen_endpoint)) == 0
        try:
            with Dumping(pkg, tmp_path / pkg, every=3) as d:
                for i in range(9):
                    cntl, _ = ch.call("EchoService.Echo",
                                      msgs.EchoRequest(message=f"m{i}"),
                                      msgs.EchoResponse,
                                      timeout_ms=WAIT_S * 1000, log_id=i)
                    assert not cntl.failed(), cntl.error_text
                # each package reads the other's dump
                other = PKGS["ref" if pkg == "port" else "port"][4]
                got[pkg] = [(m["service"], m["method"], m["log_id"], p)
                            for m, p in d.records(other)]
        finally:
            ch.close()
    assert got["port"] == got["ref"] == [
        ("EchoService", "Echo", i,
         wire.EchoRequest(message=f"m{i}").SerializeToString())
        for i in (2, 5, 8)]


def _tensor(pkg: str):
    a = np.random.default_rng(5).standard_normal((64,), np.float32)
    return torch.from_numpy(a) if pkg == "port" else jnp.asarray(a)


@pytest.mark.parametrize("pkg", PKGS)
def test_replayed_push_fails_with_1003(servers, tmp_path, pkg):
    mod, _, _, _, _, ts = PKGS[pkg]
    target = str(servers[pkg].listen_endpoint)
    opts = mod.ChannelOptions(device="cpu") if pkg == "port" else None
    devch = ts.make_device_channel(target, opts)
    ch = mod.Channel()
    assert ch.init(target) == 0
    try:
        with Dumping(pkg, tmp_path) as d:
            cntl, resp = ts.TensorClient(devch).push("x", [_tensor(pkg)])
            assert not cntl.failed() and resp.ok, cntl.error_text
            records = d.records()
        assert [(m["service"], m["method"], p) for m, p in records] == [
            ("TensorStore", "Push", wire.TensorPushRequest(
                name="x").SerializeToString())]
        assert len(records[0][1]) == 3
        meta, payload = records[0]
        # the replay of tools/rpc_replay.py: the payload as it is
        cntl, _ = ch.call(f"{meta['service']}.{meta['method']}", payload,
                          None, timeout_ms=WAIT_S * 1000,
                          log_id=meta["log_id"])
        assert (cntl.error_code, cntl.error_text) == (
            errors.EREQUEST, "no tensors in request")
    finally:
        ch.close()
        devch.close()


@pytest.mark.parametrize("path", ["/rpc_dump", "/rpc_dump?seconds=1"])
def test_rpc_dump_page_like_the_reference(servers, path):
    got = {}
    for pkg, srv in servers.items():
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.listen_endpoint.port,
                                          timeout=WAIT_S)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            got[pkg] = (r.status, r.getheader("content-type"), r.read())
        finally:
            conn.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == 200
