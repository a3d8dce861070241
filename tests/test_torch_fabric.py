"""The port's descriptor-ring lane and IOBuf arena seams against brpc_tpu's.

The ring lane between two processes of the port, for every wire dtype,
and both ways between the packages: a port client pushing into a
reference server's fabric and a reference client pushing into a port
server's. A process has one producer mapping, so every client runs in a
child of its own (the reference's with ``BRPC_TPU_NATIVE_SO`` pointing at
its library built from its own sources); the servers run in children
too. Each push must take the ring lane (``ring`` moves, ``shm`` and
``wire`` do not, nothing rides the attachment) and come back bit-equal;
after the store is dropped the port receiver holds no record, no lease
and no arena span. The arena seams (``HostArena.install_as_iobuf_allocator``
and ``install_read_arena``) run one seeded sequence of appends and socket
reads in both packages, here, and must leave the same spans taken. A
client whose build fails tries it once and pushes by shm.
"""
import json
import socket

import numpy as np
import pytest

from brpc_tpu.butil import iobuf as ref_iobuf
from brpc_tpu.rpc import device_transport as ref_dt
from brpc_tpu_torch.butil import iobuf
from brpc_tpu_torch.rpc import device_transport as dt
from test_torch_native import Peer, child_env, run_child

WIRE_DTYPES = ("float64", "float32", "float16", "bfloat16", "int64", "int32",
               "int16", "int8", "uint8", "bool")

# argv: package, endpoint, seed. Pushes a seeded tensor of every wire dtype
# by a device channel and pulls it back; prints the lanes each took.
CLIENT = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
pkg, endpoint, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
DTYPES = json.loads(sys.argv[4])

def seeded(name, i):
    rng = np.random.default_rng(seed + i)
    n = 1000 + 17 * i
    if name == "bool":
        return rng.integers(0, 2, n).astype(np.uint8)
    size = 2 if name == "bfloat16" else np.dtype(name).itemsize
    return rng.integers(0, 256, n * size, dtype=np.uint8)

if pkg == "port":
    import torch
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.rpc import device_transport as dt, tensor_service as ts
    ch = ts.make_device_channel(endpoint, rpc.ChannelOptions(device="cpu"))
    def tensor(name, raw):
        t = torch.from_numpy(raw.copy())
        return t.view(dt.DTYPES[name][0]) if name != "bool" else t.bool()
    def raw_of(t):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
else:
    import ml_dtypes
    from brpc_tpu.bthread import get_task_control
    from brpc_tpu.rpc import device_transport as dt, tensor_service as ts
    get_task_control()
    ch = ts.make_device_channel(endpoint)
    def tensor(name, raw):
        if name == "bool":
            return raw.astype(bool)
        return raw.view(ml_dtypes.bfloat16 if name == "bfloat16" else name)
    def raw_of(a):
        return np.ascontiguousarray(a).tobytes()

client = ts.TensorClient(ch)
out = {"equal": [], "attachment": 0, "pulled": []}
before = dt.lane_counters()
for i, name in enumerate(DTYPES):
    x = tensor(name, seeded(name, i))
    cntl, resp = client.push(name, [x])
    assert not cntl.failed() and resp.ok, cntl.error_text
    out["attachment"] += len(cntl.request_attachment)
    pc, got = client.pull(name)
    assert not pc.failed(), pc.error_text
    out["pulled"].append(pc._response_rpc_meta.tensors[0].sharding_spec
                         .split(":")[0])
    out["equal"].append(raw_of(got[0]) == raw_of(x)
                        and str(got[0].dtype).replace("torch.", "") == name)
after = dt.lane_counters()
out["lanes"] = {k: after[k] - before[k] for k in after}
print(json.dumps(out))
"""


def _run_client(pkg: str, peer: Peer, seed: int, **env) -> dict:
    return run_child(CLIENT, child_env(**env), pkg, peer.endpoint, str(seed),
                     json.dumps(WIRE_DTYPES), timeout_s=90)


def _ring_only(out: dict, what: str):
    n = len(WIRE_DTYPES)
    assert out["equal"] == [True] * n, (what, out)
    assert out["lanes"]["ring"] == n, (what, out)
    assert out["lanes"]["shm"] == 0 and out["lanes"]["wire"] == 0, (what, out)
    assert out["attachment"] == 0, (what, out)


def _at_rest(peer: Peer):
    peer.control("drop")
    st = peer.control("state")
    assert st["fabric"]["held_records"] == 0, st
    assert st["fabric"]["live_leases"] == 0, st
    assert st["spans"] == 0, st


@pytest.fixture(scope="module")
def port_peer():
    peer = Peer("port", child_env())
    try:
        yield peer
    finally:
        assert peer.close() == 0


def test_ring_lane_port_to_port_every_dtype(port_peer):
    out = _run_client("port", port_peer, seed=1)
    _ring_only(out, "port -> port")
    _at_rest(port_peer)


def test_ring_lane_reference_client_into_a_port_server(port_peer):
    out = _run_client("ref", port_peer, seed=2, ref_native=True)
    _ring_only(out, "reference -> port")
    _at_rest(port_peer)


# argv: endpoint. Two pushes whose producer attach finds no library.
TWICE = r"""
import json, os, sys, torch
sys.path.insert(0, os.environ["REPO"])
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import device_transport as dt, tensor_service as ts

def compiles():
    path = os.environ["COMPILES"]
    return len(open(path).readlines()) if os.path.exists(path) else 0

client = ts.TensorClient(ts.make_device_channel(
    sys.argv[1], rpc.ChannelOptions(device="cpu")))
x = torch.arange(4096, dtype=torch.float32)
out = {"ok": [], "compiles": []}
for i in range(2):
    cntl, resp = client.push(f"twice{i}", [x])
    out["ok"].append(not cntl.failed() and resp.ok)
    out["compiles"].append(compiles())
out["lanes"] = dt.lane_counters()
print(json.dumps(out))
"""


def test_a_failed_build_is_tried_once_per_process(port_peer, tmp_path):
    """A client whose compiler fails tries the build at its first push to
    a peer with a fabric, then takes shm without compiling again."""
    cxx = tmp_path / "broken-g++"
    cxx.write_text('#!/bin/sh\necho "$@" >> "$COMPILES"\nexit 1\n')
    cxx.chmod(0o755)
    out = run_child(TWICE, child_env(CXX=str(cxx),
                                     COMPILES=str(tmp_path / "compiles")),
                    port_peer.endpoint, timeout_s=90)
    assert out["ok"] == [True, True], out
    assert out["compiles"][0] > 0 and out["compiles"][1] == out["compiles"][0], out
    assert out["lanes"]["shm"] == 2 and out["lanes"]["ring"] == 0, out
    _at_rest(port_peer)


def test_ring_lane_port_client_into_a_reference_server():
    peer = Peer("ref", child_env(ref_native=True))
    try:
        _ring_only(_run_client("port", peer, seed=3), "port -> reference")
    finally:
        assert peer.close() == 0


# -- the IOBuf arena seams ----------------------------------------------------------

def _seeded_appends(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 20000)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def _arena_sequence(iobuf_mod, dt_mod, **read_arena_kw):
    """One seeded run: appends through a HostArena allocator, socket reads
    through it, then a read-arena chain that must grow. Returns what the
    spans did."""
    out = {"free": [], "bytes": b"", "grows": None}
    arena = dt_mod.HostArena(size=1 << 20)
    try:
        arena.install_as_iobuf_allocator(capacity=4096)
        bufs = []
        for data in _seeded_appends(7):
            buf = iobuf_mod.IOBuf()
            buf.append(data)
            bufs.append(buf)
            out["free"].append(arena.free_bytes())
        out["bytes"] = b"".join(bytes(b.to_bytes()) for b in bufs)
        a, b = socket.socketpair()
        try:
            a.sendall(b"x" * 30000)
            portal = iobuf_mod.IOPortal()
            got = 0
            while got < 30000:
                got += portal.append_from_socket(b, 65536)
            out["free"].append(arena.free_bytes())
            out["read"] = bytes(portal.to_bytes()) == b"x" * 30000
        finally:
            a.close()
            b.close()
        del bufs, portal
    finally:
        iobuf_mod.set_block_allocator(None)
        arena.close()
    chain = dt_mod.install_read_arena(size=64 << 10, capacity=16 << 10,
                                      **read_arena_kw)
    try:
        held = []
        for data in _seeded_appends(8, 12):
            buf = iobuf_mod.IOBuf()
            buf.append(data)
            held.append(buf)
        out["grows"] = chain.grows
        out["arenas"] = len(chain.arenas)
        out["chain_free"] = [a.free_bytes() for a in chain.arenas]
    finally:
        dt_mod.uninstall_read_arena()
    return out


def test_arena_seams_against_the_reference():
    ref = _arena_sequence(ref_iobuf, ref_dt)
    port = _arena_sequence(iobuf, dt, device="cpu")
    assert port["bytes"] == b"".join(_seeded_appends(7))
    assert port["read"] and ref["read"]
    assert port["grows"] >= 1
    assert port == ref
