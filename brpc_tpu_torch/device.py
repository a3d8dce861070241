"""Device choice for the port's entry points.

Every entry point that places tensors (init_params, entry, DeviceBlockPool,
local_device_info, the handshake halves) runs on the card unless the caller
passes ``device="cpu"``. Without CUDA a request for the card raises: no
path swaps the card for the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and CUDA
    is unavailable. A card without an index gets the current one, so two
    resolved devices compare equal when they are the same card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "brpc_tpu_torch: CUDA is not available; pass device='cpu' "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
