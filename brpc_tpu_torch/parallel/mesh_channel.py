"""MeshChannel — combo-channel semantics fused onto a mesh axis.

Port of the device half of brpc_tpu/parallel/mesh_channel.py. Where
ParallelChannel makes N socket writes and merges N responses, a
MeshChannel runs the sub-call on each participant's shard and merges with
one collective over a process group of the rank mesh:

    mc = MeshChannel(mesh, "dp")
    out = mc.parallel_call(fn, x, merger="add")   # ParallelChannel
    y   = mc.ring_call(fn, x)                     # cascade/pipeline hop
    z   = mc.partition_call(fn, x)                # PartitionChannel

Every participant calls each method with its own shard (dim 0 of the
reference's global input).

The host axis goes native: ``attach_host_cluster`` binds a NativeCluster
(rpc/native_cluster.py) whose backends are the peer hosts, and
``host_parallel_call`` fans an RPC over them through the native fan-out
core, the cross-host hop of a host x device mesh with no Python per
sub-call.
"""
from __future__ import annotations

from typing import Callable, Optional

from brpc_tpu_torch.parallel import collectives
from brpc_tpu_torch.parallel.world import RankMesh


class MeshChannel:
    """One mesh axis treated as a set of N sub-channels."""

    def __init__(self, mesh: RankMesh, axis: str, host_cluster=None):
        if axis not in mesh.spec.shape:
            raise ValueError(f"axis {axis!r} not in mesh "
                             f"{tuple(mesh.spec.shape)}")
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.size(axis)
        self.host_cluster = host_cluster

    # -- host axis (native fan-out) ---------------------------------------
    def attach_host_cluster(self, cluster):
        """Bind the host axis: a NativeCluster whose backends are the peer
        hosts of this mesh slice."""
        self.host_cluster = cluster
        return self

    def host_parallel_call(self, service_method: str, payload: bytes,
                           timeout_ms: int = 1000, fail_limit: int = 0):
        """ParallelChannel semantics over the host axis, natively: returns
        (error_code, merged_bytes, error_text, failed_subcalls)."""
        if self.host_cluster is None:
            raise ValueError("no host cluster attached (attach_host_cluster)")
        return self.host_cluster.parallel_call(service_method, payload,
                                               timeout_ms=timeout_ms,
                                               fail_limit=fail_limit)

    # -- ParallelChannel analog -------------------------------------------
    def parallel_call(self, fn: Callable, x, merger: Optional[str] = "add"):
        """Apply fn to this participant's shard, then merge with the named
        reduction: fn is the sub-call, merger the ResponseMerger.
        merger=None returns this participant's own result."""
        r = fn(x)
        if merger is None:
            return r
        if merger == "add":
            return collectives.psum(r, self.mesh, self.axis)
        if merger == "mean":
            return collectives.psum(r, self.mesh, self.axis) / self.n
        if merger == "max":
            return collectives.preduce(r, self.mesh, self.axis, "max")
        if merger == "concat":
            return collectives.allgather(self.mesh, self.axis, r)
        raise ValueError(f"unknown merger {merger}")

    def allreduce(self, x, op: str = "add"):
        return collectives.allreduce(self.mesh, self.axis, x, op)

    def allgather(self, x):
        return collectives.allgather(self.mesh, self.axis, x)

    def reduce_scatter(self, x):
        return collectives.reduce_scatter(self.mesh, self.axis, x)

    # -- cascade / pipeline analog ----------------------------------------
    def ring_call(self, fn: Callable, x, shift: int = 1):
        """Apply fn to the local shard, then pass the result to the next
        participant on the ring: the cascade_echo / pipeline-stage hop."""
        return collectives.ring_shift(self.mesh, self.axis, fn(x), shift)

    # -- PartitionChannel analog ------------------------------------------
    def partition_call(self, fn: Callable, x, gather: bool = True):
        """Each participant computes fn on its partition of the data;
        gather=True returns the concatenated full result to all."""
        return self.parallel_call(fn, x, merger="concat" if gather else None)

    def all_to_all(self, x):
        return collectives.all_to_all(self.mesh, self.axis, x)

    def bandwidth_probe(self, nbytes: int = 1 << 22, iters: int = 5) -> dict:
        return collectives.ici_bandwidth_probe(self.mesh, self.axis,
                                               nbytes, iters)
