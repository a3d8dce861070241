"""Rank functions for the port's SPMD tests (tests/test_torch_parallel.py,
tests/test_torch_spmd.py).

A spawned rank imports the module of the function it runs, so these live
apart from the test modules, which import jax. The tests import this file
as ``torch_spmd_ranks`` (pytest puts tests/ on sys.path, and a spawned
rank inherits it; a package named ``tests`` may be installed elsewhere).
This module imports torch and the port only. Each case function runs
every case of its test module in one world and returns this rank's
outputs as numpy arrays; the test process puts the ranks' outputs
together and holds them against the JAX package.
"""
import time

import torch

from brpc_tpu_torch.entry import _dryrun_rank
from brpc_tpu_torch.parallel import MeshChannel, RankMesh, collectives
from brpc_tpu_torch.parallel.world import tensors_to_numpy
from brpc_tpu_torch.tensor.config import MeshSpec, ModelConfig
from brpc_tpu_torch.tensor.model import (
    TOKENS_SPEC,
    make_spmd_forward,
    make_spmd_train_step,
    params_from_numpy,
    shard,
    shard_params,
)
from brpc_tpu_torch.tensor.ring_attention import ring_attention


def collective_cases(device, inputs):
    """The twins of tests/test_parallel_collectives.py on a dp=8 mesh. Each
    rank passes row r of each input (the reference's dim-0 shard)."""
    mesh = RankMesh(MeshSpec(dp=8))
    r = mesh.index("dp")

    def mine(name):
        return torch.from_numpy(inputs[name][r:r + 1]).to(device)

    mc = MeshChannel(mesh, "dp")
    out = {
        "allreduce_add": collectives.allreduce(mesh, "dp", mine("sum4"),
                                               "add"),
        "allreduce_max": collectives.allreduce(mesh, "dp", mine("col8"),
                                               "max"),
        "allreduce_min": collectives.allreduce(mesh, "dp", mine("col8"),
                                               "min"),
        "allreduce_mean": collectives.allreduce(mesh, "dp", mine("col8"),
                                                "mean"),
        "allgather": collectives.allgather(mesh, "dp", mine("rows3")),
        "reduce_scatter": collectives.reduce_scatter(mesh, "dp",
                                                     mine("rows16")),
        "ring_shift": collectives.ring_shift(mesh, "dp", mine("col8"), 1),
        "all_to_all": collectives.all_to_all(mesh, "dp", mine("a2a")),
        "parallel_call": mc.parallel_call(lambda s: s * 2.0, mine("sum4"),
                                          merger="add"),
        "concat_merger": mc.parallel_call(lambda s: s + 1.0, mine("col8"),
                                          merger="concat"),
        "ring_call": mc.ring_call(lambda s: s * 10.0, mine("col8")),
        "partition_call": mc.partition_call(
            lambda s: s.sum(dim=1, keepdim=True), mine("rows2")),
        "probe": mc.bandwidth_probe(nbytes=1 << 16, iters=2),
    }

    w = torch.tensor(2.0, requires_grad=True)

    def local_grad(batch):  # d/dw of sum(w * x) = sum(x)
        return torch.autograd.grad((w * batch).sum(), w)[0]

    out["grad_merge"] = mc.parallel_call(local_grad, mine("sum4"),
                                         merger="add")
    return tensors_to_numpy(out)


def spmd_cases(device, cases):
    """Every case of tests/test_torch_spmd.py, one mesh per case:
    ("ring", spec, q, k, v), ("forward", spec, cfg kwargs, params,
    tokens), ("train", spec, cfg kwargs, params, tokens, microbatches,
    lr) and ("dryrun", specs, inputs): the dry run's rank function on
    its own meshes. Returns this rank's outputs, one per case."""
    meshes = {}
    out = []
    for kind, spec, *rest in cases:
        if kind == "dryrun":
            out.append(_dryrun_rank(device, spec, rest[0]))
            continue
        if spec not in meshes:
            meshes[spec] = RankMesh(spec)
        mesh = meshes[spec]
        if kind == "ring":
            q, k, v = (shard(torch.from_numpy(a), (None, "sp"), mesh)
                       for a in rest)
            out.append(ring_attention(q, k, v, mesh, "sp", causal=True))
            continue
        cfg = ModelConfig(**rest[0])
        params = shard_params(params_from_numpy(rest[1], device=device),
                              mesh)
        tokens = torch.from_numpy(rest[2]).to(device)
        if kind == "forward":
            _, fwd = make_spmd_forward(cfg, spec, 1, mesh=mesh)
            out.append(fwd(params, shard(tokens, TOKENS_SPEC, mesh)))
            continue
        n_microbatches, lr = rest[3:]
        _, step = make_spmd_train_step(cfg, spec, n_microbatches, lr,
                                       mesh=mesh)
        labels = torch.roll(tokens, -1, dims=1)
        loss, new = step(params, shard(tokens, TOKENS_SPEC, mesh),
                         shard(labels, TOKENS_SPEC, mesh))
        out.append((loss, new))
    return tensors_to_numpy(out)


def psum_rank(device):
    """psum of (rank + 1) over a dp mesh of the whole world."""
    mesh = RankMesh(MeshSpec(dp=torch.distributed.get_world_size()))
    x = torch.full((4,), float(mesh.rank + 1), device=device)
    return float(collectives.psum(x, mesh, "dp")[0])


def failing_rank(device):
    """Rank 0 raises; the others wait in a collective it never joins."""
    if torch.distributed.get_rank() == 0:
        raise ValueError("rank 0 fails on purpose")
    torch.distributed.barrier()


def sleeping_rank(device, seconds):
    time.sleep(seconds)
