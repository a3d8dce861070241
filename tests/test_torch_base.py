"""The port's small base modules held against brpc_tpu's, on the CPU.

For ``butil.status``, ``butil.timeutil``, ``butil.containers``,
``butil.pools``, ``bvar.collector``, ``bvar.multi_dimension``,
``fleet.hist`` and ``fleet.slo``, one seeded sequence of operations goes
through the reference and the port, and the results must be equal.
Randomness is seeded the same way in both (numpy for the inputs, a
``random.Random`` of one seed for ``fast_rand``), and the clocks are
fixed: a patched ``time`` in the timer and collector modules, and fixed
``now`` values for the SLO timeline. Nothing sleeps.

The rest of the partly ported modules (ROADMAP A10) go the same way:
``IOBufAppender``, ``IOBufCutter``, ``IOPortal`` on a pipe and a socket
pair, ``append_user_data``, ``device_arrays`` (the port's tensors, the
reference's arrays) and ``cut_into_file_descriptor``, the thread's
block cache, bthread ids' ``create``, ``join`` and ``trylock``, the
socket map's ``find`` and ``count``, a dispatcher's ``stop``, ``join``
and ``remove_consumer``, and the endpoint's device coordinates. Their
waits have deadlines; two of them (0.05 s and 0.2 s) wait for what must
not come.
"""
import os
import random
import socket
import threading
import types

import numpy as np
import pytest
import torch

from brpc_tpu import Status as RefTopStatus
from brpc_tpu import bvar as ref_bvar
from brpc_tpu.butil import containers as ref_containers
from brpc_tpu.butil import pools as ref_pools
from brpc_tpu.butil import status as ref_status
from brpc_tpu.butil import timeutil as ref_timeutil
from brpc_tpu.bvar import collector as ref_collector
from brpc_tpu.bvar import multi_dimension as ref_md
from brpc_tpu.bvar import variable as ref_variable
from brpc_tpu.rpc import errors as ref_errors
from brpc_tpu.fleet import hist as ref_hist
from brpc_tpu.fleet import slo as ref_slo
from brpc_tpu_torch import Status as TopStatus
from brpc_tpu_torch import butil, bvar, fleet
from brpc_tpu_torch.butil import containers, pools, status, timeutil
from brpc_tpu_torch.bvar import collector, multi_dimension, variable
from brpc_tpu_torch.fleet import hist, slo
from brpc_tpu_torch.rpc import errors

PAIRS = {
    "status": (ref_status, status), "timeutil": (ref_timeutil, timeutil),
    "containers": (ref_containers, containers), "pools": (ref_pools, pools),
    "collector": (ref_collector, collector),
    "multi_dimension": (ref_md, multi_dimension),
    "hist": (ref_hist, hist), "slo": (ref_slo, slo),
}


def _both(name, fn):
    """fn(module) through the reference and the port: equal results."""
    ref_mod, port_mod = PAIRS[name]
    ref, port = fn(ref_mod), fn(port_mod)
    assert ref == port
    return port


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e))


# -- status ------------------------------------------------------------------

STATUS_CASES = [
    lambda m: repr(m.Status.ok()),
    lambda m: (bool(m.Status.ok()), m.Status.ok().is_ok()),
    lambda m: repr(m.Status.error(m.ELIMIT, "full")),
    lambda m: bool(m.Status.error(1, "x")),
    lambda m: _outcome(lambda: m.Status.error(0, "no")),
    lambda m: (m.Status(3, "a") == m.Status(3, "a"),
               m.Status(3, "a") == m.Status(3, "b"), m.Status() == 0),
    lambda m: sorted((k, v) for k, v in vars(m).items()
                     if k.isupper() and isinstance(v, int)),
]


@pytest.mark.parametrize("case", range(len(STATUS_CASES)))
def test_status(case):
    _both("status", STATUS_CASES[case])


def test_status_exports():
    assert TopStatus is status.Status is butil.Status
    assert RefTopStatus.__name__ == TopStatus.__name__
    # the codes rpc/errors.py shares with butil/status.py agree (ECANCELED
    # does not, in both packages: errno's there, brpc's 2007 here)
    for name in ("ENOSERVICE", "ENOMETHOD", "EREQUEST", "ERPCTIMEDOUT",
                 "EFAILEDSOCKET", "ELIMIT", "ECLOSE"):
        assert getattr(status, name) == getattr(errors, name)
    assert (status.ECANCELED, errors.ECANCELED) == (
        ref_status.ECANCELED, ref_errors.ECANCELED)


# -- timeutil ----------------------------------------------------------------

def test_timeutil_on_a_fixed_clock(monkeypatch):
    ticks = [1_000_000_000 + 1_234_567 * i for i in range(64)]

    def run(m):
        it = iter(ticks)
        fake = types.SimpleNamespace(monotonic_ns=lambda: next(it),
                                     time_ns=lambda: 1_700_000_000_123_456_789)
        monkeypatch.setattr(m, "time", fake)
        t = m.Timer()
        before = (t.n_elapsed(), t.u_elapsed(), t.m_elapsed())
        t.start()
        t.stop()
        t.stop()
        return (m.cpuwide_time_ns(), m.cpuwide_time_us(),
                m.monotonic_time_ns(), m.gettimeofday_us(), before,
                t.n_elapsed(), t.u_elapsed(), t.m_elapsed())

    _both("timeutil", run)


# -- containers --------------------------------------------------------------

def _flatmap_ops(seed: int):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, 60, 300)] + [
        f"k{int(k)}" for k in rng.integers(0, 40, 100)]
    rng.shuffle(keys)
    ops = []
    for k in keys:
        op = ["insert", "erase", "seek", "getitem", "contains"][
            int(rng.integers(0, 5))]
        ops.append((op, k, int(rng.integers(0, 1000))))
    return ops


@pytest.mark.parametrize("seed", range(3))
def test_flatmap(seed):
    def run(m):
        fm = m.FlatMap(nbucket=int(4 + seed * 3), load_factor=80)
        trace = []
        for op, k, v in _flatmap_ops(seed):
            if op == "insert":
                trace.append(fm.insert(k, v))
            elif op == "erase":
                trace.append(fm.erase(k))
            elif op == "seek":
                trace.append(fm.seek(k))
            elif op == "getitem":
                trace.append(fm[k])
            else:
                trace.append(k in fm)
            trace.append((len(fm), fm.nbucket))
        trace.append(list(fm))
        trace.append((fm.init(8), fm.empty(), fm.load_factor))
        fm.resize(7)
        trace.append(list(fm))
        fm.clear()
        trace.append((fm.empty(), fm.init(8), fm.nbucket))
        return trace

    _both("containers", run)


def test_fast_rand_crc32c_packing_threadlocal():
    data = np.random.default_rng(11).bytes(4096)

    def run(m):
        m._tls_rand.r = random.Random(1234)
        draws = [m.fast_rand(), m.fast_rand_less_than(1000),
                 m.fast_rand_less_than(0), m.fast_rand_in(-5, 5),
                 m.fast_rand_double()]
        crcs = [m.crc32c(data[:n]) for n in (0, 1, 9, 100, 4096)]
        crcs.append(m.crc32c(data[100:], m.crc32c(data[:100])))
        packed = (m.RawPacker().pack32(0xDEADBEEF).pack64(-1)
                  .pack32(1 << 33).bytes())
        un = m.RawUnpacker(packed)
        made = []
        tl = m.ThreadLocal(lambda: made.append(1) or len(made))
        got = [tl.get(), tl.get()]
        tl.reset(7)
        got.append(tl.get())
        return (draws, crcs, packed, [un.unpack32(), un.unpack64(),
                                      un.unpack32()], got, len(made))

    _both("containers", run)
    assert containers.crc32c(b"123456789") == 0xE3069283  # the check value


# -- pools -------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_resource_and_object_pools(seed):
    ops = np.random.default_rng(seed).integers(0, 4, 200)

    def run(m):
        made = []
        rp = m.ResourcePool(lambda: made.append(len(made)) or len(made))
        live, trace = [], []
        for op in ops:
            if op <= 1 or not live:
                rid, obj = rp.get_resource()
                live.append(rid)
                trace.append(("get", rid, obj))
            elif op == 2:
                rid = live.pop(0)
                trace.append(("ret", rp.return_resource(rid),
                              rp.return_resource(rid), rp.address(rid)))
            else:
                rid = live[-1]
                trace.append(("addr", rp.address(rid),
                              rp.address(rid ^ (1 << 32))))
        trace.append((rp.size(), rp.address(m.INVALID_RESOURCE_ID),
                      rp.return_resource(1 << 40)))
        op_pool = m.ObjectPool(lambda: object(), max_free=3)
        objs = [op_pool.get() for _ in range(5)]
        for o in objs:
            op_pool.put(o)
        again = op_pool.get()
        trace.append((op_pool.free_count(), op_pool.created_count(),
                      again is objs[2]))
        return trace

    _both("pools", run)
    assert butil.ResourcePool is pools.ResourcePool
    assert butil.INVALID_RESOURCE_ID == ref_pools.INVALID_RESOURCE_ID


# -- collector ---------------------------------------------------------------

class _Obj:
    def __init__(self, i, destroyed):
        self.i = i
        self._destroyed = destroyed

    def __eq__(self, other):
        return self.i == other.i


def test_collector_budget_on_a_fixed_clock(monkeypatch):
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.exponential(0.004, 900)).tolist()

    def run(m):
        clock = iter([0.0] + times)
        monkeypatch.setattr(m, "time",
                            types.SimpleNamespace(monotonic=lambda: next(clock)))
        drained = []
        c = m.Collector(max_samples_per_second=100, drain_fn=drained.extend,
                        max_pending=150)
        destroyed = []

        class Dropped(m.Collectable, _Obj):
            def destroy(self):
                destroyed.append(self.i)

        kept = [c.submit(Dropped(i, destroyed) if i % 2 else _Obj(i, None))
                for i in range(len(times))]
        pending = c.pending_count
        out = c.drain()
        return (kept, pending, [o.i for o in out], [o.i for o in drained],
                destroyed, c.submitted_count, c.sampled_count,
                c.pending_count, c.drain())

    _both("collector", run)


# -- multi_dimension ---------------------------------------------------------

def test_multi_dimension_values_and_prometheus_lines():
    rng = np.random.default_rng(4)
    labels = [(str(a), f"m{b}") for a, b in rng.integers(0, 4, (40, 2))]
    name = "test_torch_base_requests"

    def run(pkg, m, var_mod):
        md = m.MultiDimension(["code", "method"], pkg.Adder, name)
        try:
            for i, lab in enumerate(labels):
                md.get_stats(*lab).update(i)
            err = _outcome(lambda: md.get_stats("only-one"))
            before = md.count_stats()
            md.delete_stats(*labels[0])
            value = md.get_value()
            prom = [line for line in var_mod.dump_prometheus().splitlines()
                    if line.split("{")[0].split(" ")[-1] == name
                    or line == f"# TYPE {name} gauge"]
            return (err, before, md.count_stats(),
                    md.has_stats(*labels[0]), md.has_stats(*labels[1]),
                    sorted(value.items()), sorted(prom))
        finally:
            md.hide()

    ref = run(ref_bvar, ref_md, ref_variable)
    port = run(bvar, multi_dimension, variable)
    assert ref == port
    assert bvar.MultiDimension is multi_dimension.MultiDimension
    assert len(port[-1]) == 1 + port[2]


def test_multi_dimension_on_brpc_metrics_of_a_server():
    """A labelled series appears on /brpc_metrics of a port server."""
    import http.client

    from brpc_tpu_torch import rpc

    md = bvar.MultiDimension(["lane"], bvar.Adder, "test_torch_base_lane")
    md.get_stats("shm").update(3)
    srv = rpc.Server(rpc.ServerOptions(device="cpu"))
    assert srv.start("127.0.0.1:0") == 0
    try:
        c = http.client.HTTPConnection("127.0.0.1", srv.listen_endpoint.port,
                                       timeout=3)
        c.request("GET", "/brpc_metrics")
        page = c.getresponse().read().decode()
        c.close()
    finally:
        srv.stop()
        md.hide()
    assert 'test_torch_base_lane{lane="shm"} 3' in page.splitlines()


# -- fleet.hist ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_hist(seed):
    rng = np.random.default_rng(seed)
    lat = [int(x) for x in rng.lognormal(13, 2, 2000)] + [0, 1, -3, 1 << 50]

    def run(m):
        streams = [lat[i::3] for i in range(3)]
        hs = []
        for s in streams:
            h = [0] * m.NBUCKETS
            for ns in s:
                h[m.bucket_of(ns)] += 1
            hs.append(h)
        merged = m.merge(*hs)
        sparse = [[b, c] for b, c in enumerate(merged) if c] + [[99, 5]]
        qs = [m.quantile(merged, q) for q in (-1, 0, 0.5, 0.9, 0.99, 1, 2)]
        above = [m.fraction_above(merged, c) for c in (0, 1e3, 1e6, 3.3e6,
                                                        1e12)]
        return (hs, merged, m.dense(sparse), m.total(merged), qs, above,
                m.quantile([0] * 4, 0.5), m.fraction_above([], 1.0),
                [m.bucket_lo(b) for b in range(5)],
                [m.bucket_hi(b) for b in range(5)])

    _both("hist", run)
    assert fleet.hist is hist


# -- fleet.slo -----------------------------------------------------------------

def _rollups(seed: int):
    """A timeline of cumulative merged rollups at fixed times: quiet, a
    burst of slow calls and errors, then quiet again; one backend restart
    shrinks the counts."""
    rng = np.random.default_rng(seed)
    count = errs = 0
    buckets = [0] * hist.NBUCKETS
    other = [0] * hist.NBUCKETS
    out = []
    for step in range(40):
        n = int(rng.integers(50, 200))
        bad = step in range(12, 22)
        for ns in rng.lognormal(15 if not bad else 19, 1, n):
            buckets[hist.bucket_of(int(ns))] += 1
        other[hist.bucket_of(int(rng.integers(1, 10**6)))] += 1
        count += n
        errs += int(rng.integers(10, 40)) if bad else int(rng.integers(0, 2))
        if step == 30:  # a restart: the cumulative counts shrink
            count, errs = count // 2, errs // 2
            buckets = [b // 2 for b in buckets]
        out.append((1000.0 + 2.5 * step, {"methods": {
            "echo/EchoService.Echo": {"count": count, "errors": errs,
                                      "buckets": list(buckets)},
            "echo/Other.M": {"count": step, "errors": 0,
                             "buckets": list(other)},
            "tensor/TensorStore.Push": {"count": 1, "errors": 1}}}))
    return out


def _objectives(m):
    return [
        m.SloObjective("lat", kind="latency", lane="echo",
                       method="EchoService.Echo", ceiling_ms=1.0,
                       budget=0.01, fast_window_s=10, slow_window_s=40,
                       fast_burn=5, slow_burn=2),
        m.SloObjective("err", kind="errors", lane="echo", budget=0.05,
                       fast_window_s=5, slow_window_s=30),
        m.SloObjective("lane", kind="latency", lane="echo", ceiling_ms=5.0,
                       budget=0.1, fast_window_s=7.5, slow_window_s=20,
                       fast_burn=1, slow_burn=1),
        m.SloObjective("none", kind="errors", lane="missing"),
    ]


@pytest.mark.parametrize("seed", range(2))
def test_slo_engine_on_one_timeline(seed):
    rollups = _rollups(seed)

    def run(m):
        eng = m.SloEngine(_objectives(m))
        trace = []
        for now, merged in rollups:
            eng.ingest(merged, now=now)
            trace.append(eng.status())
        return (trace, eng.alerts_fired_total(), eng.alerts_cleared_total(),
                [o.name for o in eng.objectives])

    out = _both("slo", run)
    assert out[1] >= 1  # the burst fired an alert in both packages


def test_slo_objective_and_engine_refusals():
    def run(m):
        return [
            _outcome(lambda: m.SloObjective("a", kind="p50")),
            _outcome(lambda: m.SloObjective("a", budget=0.0)),
            _outcome(lambda: m.SloObjective("a", budget=1.0)),
            _outcome(lambda: m.SloEngine([m.SloObjective("a"),
                                          m.SloObjective("a")])),
            _outcome(lambda: m.SloEngine([]).status()),
        ]

    _both("slo", run)
    assert fleet.SloEngine is slo.SloEngine
    assert set(fleet.__all__) == {"SloEngine", "SloObjective", "hist"}


# -- the rest of the partly ported modules (ROADMAP A10) ---------------------

from brpc_tpu.bthread import id as ref_bthread_id  # noqa: E402
from brpc_tpu.butil import endpoint as ref_endpoint  # noqa: E402
from brpc_tpu.butil import iobuf as ref_iobuf  # noqa: E402
from brpc_tpu.rpc import event_dispatcher as ref_dispatcher  # noqa: E402
from brpc_tpu.rpc import socket_map as ref_socket_map  # noqa: E402
from brpc_tpu_torch.bthread import id as bthread_id  # noqa: E402
from brpc_tpu_torch.butil import endpoint, iobuf  # noqa: E402
from brpc_tpu_torch.rpc import event_dispatcher  # noqa: E402
from brpc_tpu_torch.rpc import socket_map  # noqa: E402

PAIRS.update({"iobuf": (ref_iobuf, iobuf), "id": (ref_bthread_id, bthread_id),
              "endpoint": (ref_endpoint, endpoint),
              "socket_map": (ref_socket_map, socket_map),
              "dispatcher": (ref_dispatcher, event_dispatcher)})


@pytest.mark.parametrize("seed", [0, 1])
def test_iobuf_appender_and_cutter(seed):
    def run(m):
        rng = random.Random(seed)
        app = m.IOBufAppender()
        for _ in range(40):
            k = rng.randrange(4)
            if k == 0:
                app.push_back(rng.randrange(256))
            elif k == 1:
                app.append(bytes(rng.randrange(256)
                                 for _ in range(rng.randrange(30))))
            elif k == 2:
                app.append("s" * rng.randrange(5))
            else:
                app.append(m.IOBuf(b"chained" * rng.randrange(3)))
        buf = app.take()
        out = [len(buf), len(app.take())]
        cut = m.IOBufCutter(buf)
        for _ in range(30):
            k = rng.randrange(4)
            if k == 0:
                out.append(_outcome(cut.cut_uint32_be))
            elif k == 1:
                out.append(_outcome(cut.cut_uint64_be))
            elif k == 2:
                out.append(_outcome(lambda: cut.cutn(rng.randrange(9))))
            else:
                out.append(cut.peek_bytes(rng.randrange(6)))
            out.append(cut.remaining())
        return out

    _both("iobuf", run)


def test_iobuf_portal_reads_a_descriptor():
    def run(m):
        r, w = os.pipe()
        os.set_blocking(r, False)
        try:
            rng = random.Random(3)
            data = bytes(rng.randrange(256) for _ in range(20000))
            p = m.IOPortal()
            out = [_outcome(lambda: p.append_from_file_descriptor(r))]
            os.write(w, data)
            out.append(p.append_from_file_descriptor(r, 9000))
            out.append(p.append_from_file_descriptor(r))
            out.append(_outcome(lambda: p.append_from_file_descriptor(r)))
            os.close(w)
            w = None
            out.append(p.append_from_file_descriptor(r))  # EOF
            out.append(p.to_bytes() == data)
            a, b = socket.socketpair()
            with a, b:
                b.sendall(data[:777])
                out.append(p.append_from_socket(a))
            out.append(len(p))
            return out
        finally:
            os.close(r)
            if w is not None:
                os.close(w)

    got = _both("iobuf", run)
    assert got[0][0] == "BlockingIOError" and got[1:3] == [9000, 11000]


def test_iobuf_user_data_device_arrays_and_fd_writes():
    def run(m, arrays):
        freed = []
        buf = m.IOBuf(b"head")
        buf.append_user_data(bytearray(b"user-memory"), deleter=freed.append,
                             meta=7)
        for a in arrays:
            buf.append_device_array(a)
        buf.append(b"tail")
        ref = buf._refs[1]
        out = [ref.block.meta, ref.block.kind]
        ref.block.release()
        ref.block.release()
        out.append(freed)
        out.append(len(buf.device_arrays()))
        r, w = os.pipe()
        try:
            out.append(buf.cut_into_file_descriptor(w, 10))
            out.append(buf.cut_into_file_descriptor(w))
            out.append(buf.cut_into_file_descriptor(w))
            out.append(os.read(r, 1 << 16))
        finally:
            os.close(r)
            os.close(w)
        return out, buf

    rng = np.random.default_rng(4)
    host = [rng.standard_normal((3, 5)).astype(np.float32),
            rng.integers(0, 9, 7).astype(np.int32)]
    ref_out, _ = run(ref_iobuf, host)
    tensors = [torch.from_numpy(h.copy()) for h in host]
    buf = iobuf.IOBuf()
    for t in tensors:
        buf.append_device_array(t)
    assert all(a is t for a, t in zip(buf.device_arrays(), tensors))
    port_out, _ = run(iobuf, tensors)
    assert port_out[:2] == [7, iobuf.Block.USER]
    assert port_out == ref_out
    assert port_out[-1] == (b"headuser-memory" + b"".join(
        h.tobytes() for h in host) + b"tail")


def test_tls_block_cache():
    def run(m):
        m.release_tls_blocks()
        b = m.share_tls_block()
        out = [m.share_tls_block() is b, b.left_space()]
        p = m.IOPortal()
        r, w = os.pipe()
        try:
            os.write(w, b"x" * 5000)
            p.append_from_file_descriptor(r)
            out.append(b.left_space())
            os.write(w, b"y" * 5000)
            p.append_from_file_descriptor(r)
        finally:
            os.close(r)
            os.close(w)
        c = m.share_tls_block()
        out += [c is b, c.left_space(), p.to_bytes() == b"x" * 5000 +
                b"y" * 5000, len(m._tls_block_cache())]
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            m.share_tls_block() is not c))
        t.start()
        t.join(5)
        m.release_tls_blocks()
        out += seen + [len(m._tls_block_cache()), m.share_tls_block() is c]
        return out

    assert _both("iobuf", run) == [True, 8192, 3192, False, 6384, True, 1,
                                   True, 0, False]


def test_bthread_id_create_join_trylock():
    def run(m):
        seen = []
        cid = m.create(data="d", on_error=lambda i, d, code, text: (
            seen.append((d, code, text)), m.unlock(i)))
        out = [m.trylock(cid), m.trylock(cid)]
        out.append(m.error(cid, 5, "queued"))
        m.unlock(cid)  # runs the queued error, which unlocks
        out.append(list(seen))
        out.append(m.join(cid, timeout=0.05))  # still alive
        done = []
        t = threading.Thread(target=lambda: done.append(m.join(cid, 5)))
        t.start()
        m.lock(cid)
        m.unlock_and_destroy(cid)
        t.join(5)
        out += [done, m.join(cid), m.trylock(cid),
                _outcome(lambda: m.trylock((1 << 60) | 1))]
        return out

    assert _both("id", run)[:2] == ["d", None]


def test_socket_map_find_and_count():
    def run(m, insert):
        smap = m.SocketMap()
        ep = PAIRS["endpoint"][0 if m is ref_socket_map else 1].EndPoint(
            "127.0.0.1", 9)
        keys = [m.make_key(ep), m.make_key(ep, protocol="h2:grpc")]
        out = [smap.count(), smap.find(ep), smap.find(key=keys[1])]
        sids = [insert(smap, ep, k) for k in keys + keys[:1]]
        out += [smap.count(), sids[0] == sids[2],
                smap.find(key=keys[0]) == sids[0],
                smap.find(key=keys[1]) == sids[1]]
        out.append(_outcome(smap.find))
        for k in keys + keys[:1]:
            smap.remove(key=k)
        out += [smap.count(), smap.find(key=keys[0])]
        return out

    ref = run(ref_socket_map, lambda s, ep, k: s.insert(ep, key=k))
    port = run(socket_map, lambda s, ep, k: s.insert(ep, k))
    assert ref == port
    # the default key is the port's tpu_std channel's, the reference's
    # bare endpoint's: find(ep) reads each package's own default
    assert socket_map.make_key(endpoint.EndPoint("h", 1))[2] == "tpu_std"


def test_event_dispatcher_stop_join_and_remove_consumer():
    def run(m):
        d = m.EventDispatcher()
        r, w = os.pipe()
        os.set_blocking(r, False)
        hits = threading.Event()

        def on_readable():
            try:
                os.read(r, 64)
            except BlockingIOError:
                pass
            hits.set()

        try:
            d.add_consumer(r, on_readable)
            os.write(w, b"a")
            out = [hits.wait(5)]
            d.remove_consumer(r)
            hits.clear()
            marker = threading.Event()
            d.add_epollout(w, marker.set)  # runs after the remove applied
            out.append(marker.wait(5))
            os.write(w, b"b")
            out.append(hits.wait(0.2))
            out.append(os.read(r, 64))  # the fd was left open
            d.stop()
            d.join(5)
            out.append(d._thread.is_alive())
            return out
        finally:
            os.close(r)
            os.close(w)

    assert _both("dispatcher", run) == [True, True, False, b"b", False]


def test_endpoint_device_coordinates():
    def run(m):
        coord = m.DeviceCoord(1, 2, 3, 0)
        ep = m.EndPoint.of_device(coord, 8000)
        plain = m.EndPoint.parse("10.0.0.1:80")
        moved = plain.with_device(coord)
        return [str(ep), ep.is_ici(), plain.is_ici(), str(moved),
                moved.is_ici(), moved == plain, str(m.EndPoint.parse(
                    str(moved))), m.EndPoint.parse(str(moved)).is_ici()]

    assert _both("endpoint", run)[:3] == ["0.0.0.0:8000/tpu:1.2.3.0", True,
                                         False]
