"""Entry point: the flagship forward at the reference's toy config.

Counterpart of ``__graft_entry__.entry``: returns ``(fn, (params, tokens))``
with ``fn(params, tokens) -> logits``. Runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from brpc_tpu_torch.device import DeviceLike, resolve_device
from brpc_tpu_torch.tensor import ModelConfig, forward_local, init_params


def entry(device: DeviceLike = None):
    dev = resolve_device(device)
    cfg = ModelConfig(
        vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
        n_layers=2, n_experts=4,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, pp_stages=1, device=dev)
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward_local(params, tokens, cfg)

    return fn, (params, tokens)
