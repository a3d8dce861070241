"""tensor — the flagship model, ported to PyTorch.

Counterpart of brpc_tpu/tensor: RMSNorm, causal and ring attention, top-1
MoE (expert-parallel over ``ep``), the GPipe pipeline and the tied
unembedding, composed by ``forward_local`` on one device and by
``make_spmd_forward`` / ``make_spmd_train_step`` over the five-axis mesh.
"""

from brpc_tpu_torch.tensor.config import ModelConfig  # noqa: F401
from brpc_tpu_torch.tensor.model import (  # noqa: F401
    forward_local,
    init_params,
    make_spmd_forward,
    make_spmd_train_step,
    params_from_numpy,
)
