"""butil — host utilities: IOBuf, flags, EndPoint, DoublyBufferedData,
Status, the object and resource pools, time helpers and the small
containers (FlatMap, fast_rand, crc32c, raw packing, ThreadLocal)."""

from brpc_tpu_torch.butil.status import Status  # noqa: F401
from brpc_tpu_torch.butil.pools import (  # noqa: F401
    INVALID_RESOURCE_ID,
    ObjectPool,
    ResourcePool,
)
