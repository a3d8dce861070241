"""Collective verbs over one axis of a RankMesh, on torch.distributed.

Port of brpc_tpu/parallel/collectives.py. The reference builds a
shard_map'd closure over a global array; here every rank calls the verb
with its own shard, so the API is per rank:

* ``allreduce(mesh, axis, x, op)`` — x is this participant's (1, ...) slot
  of the reference's (N, ...) input; every participant gets the reduction
  of the slots, shape x.shape[1:] (the reference's replicated ``P()``).
* ``allgather`` — x is this participant's rows; every participant gets
  all rows in axis order.
* ``reduce_scatter`` — x is (1, L); the result is (1, L/N), this
  participant's slice of the sum (``P(axis)``).
* ``ring_shift`` — x moves to participant (i + shift) % N.
* ``all_to_all`` — x is (1, N, ...), slot j for participant j; the result
  is (1, N, ...) with slot j from participant j.

The model's verbs are ``torch.autograd.Function``s with JAX's transposes
(under ``shard_map(check=False)``): ``psum`` sums in both directions,
``ppermute`` sends the cotangent back along the inverse permutation, and
``all_to_all_dim0`` (split 0, concat 0, untiled) is its own transpose.
``torch.distributed.nn.functional`` is not used: its backward rules have
changed across torch releases.

Every rank of a group must call the same verbs in the same order, in the
forward and in the backward; the model keeps its graph the same on every
rank (rank-dependent choices are ``torch.where`` on a flag, not Python
branches), so autograd runs the backward verbs in the same order too.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from brpc_tpu_torch.parallel.world import RankMesh

_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _reduce(x, mesh: RankMesh, axes, op=dist.ReduceOp.SUM):
    """The reduction of x over the group of ``axes``, in a new tensor."""
    y = torch.clone(x, memory_format=torch.contiguous_format)
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(y, op=op, group=group)
    return y


def _permute(x, mesh: RankMesh, axis: str, perm):
    """Send x to ``perm``'s destination of this participant and return
    what its source sent; zeros where no one sends here (lax.ppermute)."""
    me = mesh.index(axis)
    dst = {s: d for s, d in perm}.get(me)
    src = {d: s for s, d in perm}.get(me)
    x = x.contiguous()
    if src == me:
        return x.clone()
    out = torch.zeros_like(x)
    group = mesh.group(axis)
    ops = []
    if dst is not None and dst != me:
        ops.append(dist.P2POp(dist.isend, x, mesh.global_rank(axis, dst),
                              group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, mesh.global_rank(axis, src),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _exchange(x, mesh: RankMesh, axis: str):
    """Chunk j of x's dim 0 to participant j; chunk j of the result from
    participant j."""
    if x.shape[0] != mesh.size(axis):
        raise ValueError(f"dim 0 of {tuple(x.shape)} must be the size of "
                         f"axis {axis} ({mesh.size(axis)})")
    x = x.contiguous()
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = [(d, s) for s, d in perm]
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, ctx.axis, ctx.inverse), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis), None, None


def psum(x, mesh: RankMesh, axes):
    """lax.psum over an axis or axis set; its transpose is a psum."""
    return _PSum.apply(x, mesh, axes)


def ppermute(x, mesh: RankMesh, axis: str, perm):
    """lax.ppermute with ``perm`` as (source, destination) axis indices; a
    participant no one sends to gets zeros. A ring of one is the identity
    (no backend sends to itself)."""
    return _PPermute.apply(x, mesh, axis, [tuple(p) for p in perm])


def all_to_all_dim0(x, mesh: RankMesh, axis: str):
    """lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False):
    dim 0 of x has the axis's size; its own transpose."""
    return _AllToAll.apply(x, mesh, axis)


def preduce(x, mesh: RankMesh, axes, op: str):
    """lax.pmax / lax.pmin (``op`` "max" or "min"); not differentiated."""
    return _reduce(x, mesh, axes, _OPS[op])


def allreduce(mesh: RankMesh, axis: str, x, op: str = "add"):
    """Every participant contributes x[0] and receives the reduction: the
    ParallelChannel + ResponseMerger fusion of SURVEY.md section 2.12."""
    x = x[0]
    if op == "add":
        return psum(x, mesh, axis)
    if op == "mean":
        return psum(x, mesh, axis) / mesh.size(axis)
    if op in ("max", "min"):
        return preduce(x, mesh, axis, op)
    raise ValueError(f"unknown op {op}")


def allgather(mesh: RankMesh, axis: str, x):
    """This participant's rows gathered with every other's, in axis order,
    to every participant."""
    x = x.contiguous()
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    out = x.new_empty((mesh.size(axis) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(mesh: RankMesh, axis: str, x):
    """x: (1, L), this participant's full-length contribution; returns
    (1, L/N), the slice of the sum this participant owns."""
    n = mesh.size(axis)
    x = x[0].contiguous()
    if x.shape[0] % n:
        raise ValueError(f"length {x.shape[0]} does not divide by {n}")
    group = mesh.group(axis)
    if group is None:
        return x.clone()[None]
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out[None]


def ring_shift(mesh: RankMesh, axis: str, x, shift: int = 1):
    """Neighbour exchange along the ring: the cascade/pipeline hop and the
    building block of ring attention."""
    n = mesh.size(axis)
    return ppermute(x, mesh, axis, [(i, (i + shift) % n) for i in range(n)])


def all_to_all(mesh: RankMesh, axis: str, x):
    """x: (1, N, ...), slot j this participant's message to j; returns
    (1, N, ...) with slot j the message from j. The PartitionChannel /
    expert-dispatch verb (MoE)."""
    return all_to_all_dim0(x[0], mesh, axis)[None]


def ici_bandwidth_probe(mesh: RankMesh, axis: str, nbytes: int = 1 << 24,
                        iters: int = 10) -> dict:
    """Achieved all-reduce bandwidth over ``axis``: the rdma_performance
    harness analog (example/rdma_performance/client.cpp). Called by every
    participant; the keys are the reference's. On the card this is NCCL's
    rate (NVLink between cards; one card's memory at world 1), on the CPU
    gloo's.

    Every participant reduces the whole float32 payload. The reference's
    closure takes ``x[0]`` of each participant's shard and so reduces one
    scalar while it reports the whole payload's bytes (ROADMAP queue C)."""
    n = mesh.size(axis)
    elems = max(n, nbytes // 4 // n * n)
    x = torch.ones((elems,), dtype=torch.float32, device=mesh.device)
    group = mesh.group(axis)

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def run():
        if group is not None:
            dist.all_reduce(x, group=group)

    run()  # warm: the communicator and its buffers
    sync()
    if group is not None:
        dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    sync()
    dt = time.perf_counter() - t0
    total_bytes = x.numel() * x.element_size() * iters
    # a ring all-reduce moves 2*(n-1)/n of the data per link
    algo_bytes = total_bytes * 2 * (n - 1) / n
    return {
        "axis_size": n,
        "payload_bytes": int(x.numel() * x.element_size()),
        "iters": iters,
        "seconds": dt,
        "allreduce_GBps": total_bytes / dt / 1e9,
        "algo_GBps": algo_bytes / dt / 1e9,
    }
