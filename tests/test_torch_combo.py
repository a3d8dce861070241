"""The port's combo channels held against brpc_tpu's, on the CPU.

Twins of tests/test_combo_channels.py: each case runs on both packages,
the reference's channels against three reference servers and the port's
against three port servers in this process, and both must give the same
merged response. Fan-out, partial failure, ``fail_limit``, a call mapper,
selective failover, partition, the partition parser's garbage cases and
the dynamic partition; the default merger's bytes; ``native=True``
refused by the port, which has no native runtime.
"""
import pytest

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control
from brpc_tpu.rpc import errors as ref_errors
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.proto import wire

DEAD = "127.0.0.1:1"


def _echo_service(mod, msgs):
    class TaggedEcho(mod.Service):
        SERVICE_NAME = "EchoService"

        def __init__(self, name):
            self.name = name

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = self.name
            done()

    return TaggedEcho


# the two packages side by side: rpc module, messages, server options
PKGS = {
    "ref": (ref_rpc, echo_pb2, lambda: ref_rpc.ServerOptions(num_threads=2)),
    "port": (rpc, wire, lambda: rpc.ServerOptions(device="cpu")),
}


@pytest.fixture(scope="module")
def trios():
    get_task_control()  # the bthread pool's first sizing sticks: the default
    out = {}
    try:
        for pkg, (mod, msgs, opts) in PKGS.items():
            svc_cls = _echo_service(mod, msgs)
            out[pkg] = []
            for i in range(3):
                srv = mod.Server(opts())
                assert srv.add_service(svc_cls(f"n{i}")) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg].append(srv)
        yield out
    finally:
        for servers in out.values():
            for srv in servers:
                srv.stop()


def _merger(mod, sep=";"):
    class ConcatMerger(mod.ResponseMerger):
        def merge(self, main_response, sub_response):
            main_response.message += sub_response.message + sep
            return 0

    return ConcatMerger()


def _parts(resp, sep=";"):
    return sorted(filter(None, resp.message.split(sep)))


def _both(trios, case):
    """Run case(pkg, mod, msgs, servers) on both packages; return the two
    results after checking they are equal."""
    got = {pkg: case(pkg, PKGS[pkg][0], PKGS[pkg][1], trios[pkg])
           for pkg in PKGS}
    assert got["port"] == got["ref"]
    return got["ref"]


def _channel(mod, target, **opts):
    ch = mod.Channel(mod.ChannelOptions(**opts) if opts else None)
    assert ch.init(target if isinstance(target, str)
                   else str(target.listen_endpoint)) == 0
    return ch


def _call(chan, msgs, message="x", timeout_ms=3000):
    cntl, resp = chan.call("EchoService.Echo",
                           msgs.EchoRequest(message=message),
                           msgs.EchoResponse, timeout_ms=timeout_ms)
    return cntl.error_code, resp


def test_parallel_channel_fans_out(trios):
    def case(pkg, mod, msgs, servers):
        pc = mod.ParallelChannel()
        for srv in servers:
            pc.add_channel(_channel(mod, srv), response_merger=_merger(mod))
        code, resp = _call(pc, msgs)
        return code, _parts(resp)

    assert _both(trios, case) == (0, ["n0", "n1", "n2"])


def test_parallel_channel_tolerates_partial_failure(trios):
    def case(pkg, mod, msgs, servers):
        pc = mod.ParallelChannel()  # fail_limit: all
        for srv in servers[:2]:
            pc.add_channel(_channel(mod, srv), response_merger=_merger(mod))
        pc.add_channel(_channel(mod, DEAD, max_retry=0, timeout_ms=300),
                       response_merger=_merger(mod))
        code, resp = _call(pc, msgs)
        return code, _parts(resp)

    assert _both(trios, case) == (0, ["n0", "n1"])


def test_parallel_channel_fail_limit_one(trios):
    def case(pkg, mod, msgs, servers):
        pc = mod.ParallelChannel(fail_limit=1)
        pc.add_channel(_channel(mod, servers[0]))
        pc.add_channel(_channel(mod, DEAD, max_retry=0, timeout_ms=300))
        return _call(pc, msgs)[0]

    assert _both(trios, case) == errors.ETOOMANYFAILS == ref_errors.ETOOMANYFAILS


def test_parallel_channel_call_mapper(trios):
    def case(pkg, mod, msgs, servers):
        class IndexMapper(mod.CallMapper):
            def map(self, i, method, request, response):
                if i == 2:
                    return mod.SubCall.skip_call()
                return mod.SubCall(method,
                                   msgs.EchoRequest(message=f"sub{i}"),
                                   msgs.EchoResponse())

        pc = mod.ParallelChannel()
        for srv in servers:
            pc.add_channel(_channel(mod, srv), call_mapper=IndexMapper(),
                           response_merger=_merger(mod))
        code, resp = _call(pc, msgs, "main")
        return code, _parts(resp)

    assert _both(trios, case) == (0, ["n0", "n1"])


def test_default_merger_bytes():
    """The default ResponseMerger is protobuf's MergeFrom: the same bytes
    from both packages."""
    out = []
    for mod, msgs in ((ref_rpc, echo_pb2), (rpc, wire)):
        main = msgs.EchoResponse(message="main")
        merger = mod.ResponseMerger()
        assert merger.merge(main, msgs.EchoResponse()) == 0
        first = main.SerializeToString()
        assert merger.merge(main, msgs.EchoResponse(message="sub")) == 0
        out.append((first, main.SerializeToString()))
    assert out[0] == out[1]
    assert wire.EchoRequest(message="a", sleep_us=-3, code=7).SerializeToString() \
        == echo_pb2.EchoRequest(message="a", sleep_us=-3, code=7).SerializeToString()


def test_selective_channel_failover(trios):
    def case(pkg, mod, msgs, servers):
        sc = mod.SelectiveChannel(max_retry=2)
        sc.add_channel(_channel(mod, DEAD, max_retry=0, timeout_ms=200))
        sc.add_channel(_channel(mod, servers[0]))
        return [(code, r.message)
                for code, r in (_call(sc, msgs, "s", 2000) for _ in range(4))]

    assert _both(trios, case) == [(0, "n0")] * 4


def test_partition_channel(trios):
    def case(pkg, mod, msgs, servers):
        url = "list://" + ",".join(f"{srv.listen_endpoint} {i}/3"
                                   for i, srv in enumerate(servers))
        pc = mod.PartitionChannel()
        assert pc.init(3, url, "rr") == 0
        assert pc.channel_count == 3
        for i in range(len(pc._subs)):
            ch, m, _ = pc._subs[i]
            pc._subs[i] = (ch, m, _merger(mod, ","))
        try:
            code, resp = _call(pc, msgs, "p")
            return code, _parts(resp, ",")
        finally:
            pc.stop()

    assert _both(trios, case) == (0, ["n0", "n1", "n2"])


@pytest.mark.parametrize("tag", ["2/4", "4/4", "x/4", "", "0/1", "-1/3",
                                 "1/", "/3", "3/2", "1/3/5"])
def test_partition_parser_twins(tag):
    want = ref_rpc.PartitionParser().parse(tag)
    assert rpc.PartitionParser().parse(tag) == want


def test_dynamic_partition_channel(trios):
    def case(pkg, mod, msgs, servers):
        # two schemes: 1-way (n0) and 2-way (n1, n2)
        url = (f"list://{servers[0].listen_endpoint} 0/1,"
               f"{servers[1].listen_endpoint} 0/2,"
               f"{servers[2].listen_endpoint} 1/2")
        dc = mod.DynamicPartitionChannel()
        assert dc.init(url, "rr") == 0
        seen = set()
        try:
            for _ in range(40):
                code, resp = _call(dc, msgs, "d")
                assert code == 0
                seen.add(resp.message)
                if "n0" in seen and ("n1" in seen or "n2" in seen):
                    break
            return sorted(dc._schemes), "n0" in seen, bool(seen - {"n0"})
        finally:
            dc.stop()

    assert _both(trios, case) == ([1, 2], True, True)


def test_native_combo_channels_are_refused():
    for cls in (rpc.ParallelChannel, rpc.PartitionChannel,
                rpc.DynamicPartitionChannel, rpc.SelectiveChannel):
        with pytest.raises(ValueError, match="native"):
            cls(native=True)
