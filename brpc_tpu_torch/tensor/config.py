"""Model / mesh configuration for the flagship tensor-transport model.

A copy of brpc_tpu/tensor/config.py: pure dataclasses, no framework import.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    d_head: int = 32
    d_ff: int = 256
    n_layers: int = 2  # layers PER pipeline stage
    n_experts: int = 4
    expert_capacity_factor: float = 2.0
    dtype: str = "bfloat16"

    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.d_head


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh axes. Sizes multiply to the device count.

    dp: data (batch) replication of params / sharding of batch
    pp: pipeline stages
    tp: tensor (megatron) sharding of heads / ffn
    sp: sequence (context) sharding — ring attention axis
    ep: expert sharding — MoE all_to_all axis
    """

    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    AXIS_NAMES: Tuple[str, ...] = ("dp", "pp", "tp", "sp", "ep")

    @property
    def shape(self):
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp, "sp": self.sp, "ep": self.ep}

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    @classmethod
    def factorize(cls, n: int) -> "MeshSpec":
        """Spread n devices over axes, preferring tp, pp, dp, then sp, ep —
        all five axes exist (size>=1) so every collective path executes."""
        sizes = {"dp": 1, "pp": 1, "tp": 1, "sp": 1, "ep": 1}
        order = ["tp", "pp", "dp", "sp", "ep"]
        i = 0
        while n % 2 == 0 and n > 1:
            sizes[order[i % len(order)]] *= 2
            n //= 2
            i += 1
        sizes["dp"] *= n  # odd remainder rides dp
        return cls(**sizes)
