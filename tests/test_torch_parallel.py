"""The port's collective layer held against brpc_tpu.parallel on the CPU.

Twins of the 12 tests of tests/test_parallel_collectives.py. The port runs
one process per rank: one 8-rank gloo world (with a deadline, so a hung
collective fails the module instead of the suite) runs every case, each
rank on its own row of the inputs; each test reassembles the ranks'
outputs and compares them with the JAX function on the same numpy
inputs. Sums are compared at fp32 tolerance (the two reduce in different
orders), everything else exactly.
"""
import time

import jax
import numpy as np
import pytest

from brpc_tpu import parallel
from brpc_tpu_torch.parallel import run_ranks
import torch_spmd_ranks  # tests/ is on sys.path (rootdir insertion)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device test mesh"
)

WORLD_DEADLINE_S = 120.0
FP32 = dict(rtol=1e-6, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "sum4": rng.normal(size=(8, 4)).astype(np.float32),
        "col8": np.arange(8.0, dtype=np.float32).reshape(8, 1),
        "rows3": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
        "rows16": rng.normal(size=(8, 16)).astype(np.float32),
        "rows2": np.arange(16.0, dtype=np.float32).reshape(8, 2),
        "a2a": np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2),
    }


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's outputs: one gloo world for the whole module."""
    return run_ranks(torch_spmd_ranks.collective_cases, 8, args=(inputs,),
                     device="cpu", deadline_s=WORLD_DEADLINE_S)


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh({"dp": 8})


def _replicated(ranks, name):
    """A replicated output: every rank's copy, checked equal, then one."""
    first = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name], first)
    return first


def _sharded(ranks, name):
    return np.concatenate([r[name] for r in ranks])


def test_allreduce_add(ranks, inputs, mesh):
    want = parallel.allreduce(mesh, "dp", inputs["sum4"], "add")
    np.testing.assert_allclose(_replicated(ranks, "allreduce_add"),
                               np.asarray(want), **FP32)


def test_allreduce_max_min_mean(ranks, inputs, mesh):
    for op in ("max", "min", "mean"):
        want = np.asarray(parallel.allreduce(mesh, "dp", inputs["col8"], op))
        got = _replicated(ranks, f"allreduce_{op}")
        np.testing.assert_array_equal(got, want)
    assert float(_replicated(ranks, "allreduce_max")[0]) == 7.0
    assert float(_replicated(ranks, "allreduce_mean")[0]) == 3.5


def test_allgather(ranks, inputs, mesh):
    want = np.asarray(parallel.allgather(mesh, "dp", inputs["rows3"]))
    np.testing.assert_array_equal(_replicated(ranks, "allgather"), want)


def test_reduce_scatter(ranks, inputs, mesh):
    want = np.asarray(parallel.reduce_scatter(mesh, "dp", inputs["rows16"]))
    got = _sharded(ranks, "reduce_scatter")
    assert got.shape == want.shape == (8, 2)
    np.testing.assert_allclose(got, want, **FP32)


def test_ring_shift(ranks, inputs, mesh):
    want = np.asarray(parallel.ring_shift(mesh, "dp", inputs["col8"], 1))
    np.testing.assert_array_equal(_sharded(ranks, "ring_shift"), want)
    np.testing.assert_array_equal(
        want.ravel(), np.roll(np.arange(8, dtype=np.float32), 1))


def test_all_to_all(ranks, inputs, mesh):
    want = np.asarray(parallel.all_to_all(mesh, "dp", inputs["a2a"]))
    got = _sharded(ranks, "all_to_all")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.swapaxes(inputs["a2a"], 0, 1))


def test_mesh_channel_parallel_call(ranks, inputs, mesh):
    mc = parallel.MeshChannel(mesh, "dp")
    want = mc.parallel_call(lambda s: s * 2.0, inputs["sum4"], merger="add")
    np.testing.assert_allclose(_replicated(ranks, "parallel_call"),
                               np.asarray(want), **FP32)


def test_mesh_channel_concat_merger(ranks, inputs, mesh):
    mc = parallel.MeshChannel(mesh, "dp")
    want = mc.parallel_call(lambda s: s + 1.0, inputs["col8"],
                            merger="concat")
    got = _replicated(ranks, "concat_merger")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got.ravel(), np.arange(1.0, 9.0))


def test_mesh_channel_ring_call(ranks, inputs, mesh):
    mc = parallel.MeshChannel(mesh, "dp")
    want = mc.ring_call(lambda s: s * 10.0, inputs["col8"])
    np.testing.assert_array_equal(_sharded(ranks, "ring_call"),
                                  np.asarray(want))


def test_mesh_channel_partition_call(ranks, inputs, mesh):
    mc = parallel.MeshChannel(mesh, "dp")
    want = mc.partition_call(lambda s: s.sum(axis=1, keepdims=True),
                             inputs["rows2"])
    got = _replicated(ranks, "partition_call")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got.ravel(), inputs["rows2"].sum(1))


def test_bandwidth_probe(ranks, mesh):
    """Same keys and payload. ROADMAP queue C #7: the reference's probe
    closure reduces x[0] of each shard, one scalar, whatever the payload;
    the port reduces the whole payload."""
    want = parallel.MeshChannel(mesh, "dp").bandwidth_probe(nbytes=1 << 16,
                                                            iters=2)
    x = jax.numpy.ones((1 << 14,), jax.numpy.float32)
    probe_fn = parallel.collectives._allreduce_fn(mesh, "dp", x.shape,
                                                  "float32", "add")
    assert probe_fn(x).shape == ()
    for r in ranks:
        stats = r["probe"]
        assert set(stats) == set(want)
        assert stats["axis_size"] == want["axis_size"] == 8
        assert stats["payload_bytes"] == want["payload_bytes"] == 1 << 16
        assert stats["iters"] == 2
        assert stats["allreduce_GBps"] > 0 and stats["algo_GBps"] > 0


def test_grad_merge_matches_parallel_channel_semantics(ranks, inputs, mesh):
    """DP gradient merge == ParallelChannel fan-out + add-merger."""
    mc = parallel.MeshChannel(mesh, "dp")
    w = np.float32(2.0)

    def local_grad(batch):  # d/dw of sum(w * x) = sum(x)
        return jax.grad(lambda w_, b: (w_ * b).sum())(w, batch)

    want = float(mc.parallel_call(local_grad, inputs["sum4"], merger="add"))
    got = float(_replicated(ranks, "grad_merge"))
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(got, float(inputs["sum4"].sum()), **FP32)


def test_rank_failure_reaches_the_caller():
    """A rank's exception fails the call at once, with its traceback, and
    the ranks still waiting in a collective are stopped."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(torch_spmd_ranks.failing_rank, 2, device="cpu",
                  deadline_s=WORLD_DEADLINE_S)
    assert time.monotonic() - t0 < WORLD_DEADLINE_S / 2


def test_world_past_its_deadline_is_stopped():
    deadline = 4.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(torch_spmd_ranks.sleeping_rank, 2, args=(60.0,),
                  device="cpu", deadline_s=deadline)
    assert time.monotonic() - t0 < deadline + 10
