"""parallel — the collective layer of the port, on torch.distributed.

Counterpart of brpc_tpu/parallel: the collective verbs and MeshChannel,
per rank, plus what one process per rank needs and the reference does not
(``world``: the rank mesh and the spawn harness).
"""

from brpc_tpu_torch.parallel.collectives import (  # noqa: F401
    all_to_all,
    allgather,
    allreduce,
    ici_bandwidth_probe,
    reduce_scatter,
    ring_shift,
)
from brpc_tpu_torch.parallel.mesh_channel import MeshChannel  # noqa: F401
from brpc_tpu_torch.parallel.world import RankMesh, run_ranks  # noqa: F401
