"""tensor — the flagship model's single-device forward, ported to PyTorch.

Counterpart of brpc_tpu/tensor: RMSNorm, causal attention, top-1 MoE and
the tied unembedding, composed by ``forward_local``.
"""

from brpc_tpu_torch.tensor.config import ModelConfig  # noqa: F401
from brpc_tpu_torch.tensor.model import (  # noqa: F401
    forward_local,
    init_params,
    params_from_numpy,
)
