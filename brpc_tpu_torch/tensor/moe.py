"""Top-1 mixture of experts, all experts on one device.

Port of brpc_tpu/tensor/moe.py: ``MoEParams``, ``init_moe``, ``_route`` and
``moe_layer``, with all experts local or, over an ``ep`` axis of a rank
mesh, the local expert shard between two all_to_alls.

Numerics follow the reference: router logits in the input dtype, an fp32
softmax, ``argmax`` taking the first of equal maxima, capacity
``max(1, int(cf * N / E))``, tokens past capacity dropped, dense one-hot
dispatch/combine einsums in the input dtype, and the tanh approximation of
gelu (``jax.nn.gelu``'s default; torch's default is the erf form).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from brpc_tpu_torch.parallel import collectives


class MoEParams(NamedTuple):
    router: torch.Tensor  # [D, E]
    w_in: torch.Tensor  # [E, D, F]
    w_out: torch.Tensor  # [E, F, D]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype, device) -> MoEParams:
    """Normal weights with the reference's scales. Draws on the generator's
    device, then moves to ``device``."""

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * scale).to(device=device, dtype=dtype)

    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)
    return MoEParams(
        router=normal((d_model, n_experts), scale_in),
        w_in=normal((n_experts, d_model, d_ff), scale_in),
        w_out=normal((n_experts, d_ff, d_model), scale_out),
    )


def _route(x, router, n_experts: int, capacity: int):
    """Top-1 routing -> (dispatch [N,E,C] one-hot, combine [N,E,C] weighted),
    both float32."""
    logits = torch.einsum("nd,de->ne", x, router)
    probs = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)  # [N]; first of equal maxima
    gate = probs.amax(dim=-1)  # [N]
    onehot = F.one_hot(expert, n_experts).float()  # [N,E]
    # Position of each token within its expert's capacity buffer.
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0  # [N,E], -1 if unrouted
    in_cap = (pos >= 0) & (pos < capacity)
    pos_cap = pos.clamp(0, capacity - 1).long()
    cap_onehot = F.one_hot(pos_cap, capacity).float()  # [N,E,C]
    dispatch = cap_onehot * in_cap[..., None]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def moe_layer(params: MoEParams, x, *, n_experts: int,
              capacity_factor: float = 2.0, mesh=None,
              ep_axis: str | None = None):
    """Run the MoE on x: [N, D] local tokens (flattened batch*seq). With
    ``ep_axis`` (an axis of ``mesh``), params.w_in/w_out hold only the
    local expert shard [E/ep, D, F] and the expert buffers travel by
    all_to_all; without it all experts are local."""
    N, D = x.shape
    capacity = max(1, int(capacity_factor * N / n_experts))
    dispatch, combine = _route(x, params.router, n_experts, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    # Dense dispatch: [E, C, D] expert input buffers.
    buf = torch.einsum("nec,nd->ecd", dispatch, x)

    if ep_axis is not None:
        ep = mesh.size(ep_axis)
        e_local = n_experts // ep
        if e_local * ep != n_experts:
            raise ValueError(f"n_experts {n_experts} must divide by ep {ep}")
        # [E, C, D] -> [ep, E_local, C, D]; afterwards dim 0 indexes the
        # source peer: this rank's local experts' slots from every peer.
        buf = buf.reshape(ep, e_local, capacity, D)
        buf = collectives.all_to_all_dim0(buf, mesh, ep_axis)
        buf = buf.permute(1, 0, 2, 3).reshape(e_local, ep * capacity, D)
        y = torch.einsum("ecd,edf->ecf", buf, params.w_in)
        y = F.gelu(y, approximate="tanh")
        y = torch.einsum("ecf,efd->ecd", y, params.w_out)
        y = y.reshape(e_local, ep, capacity, D).permute(1, 0, 2, 3)
        y = collectives.all_to_all_dim0(y, mesh, ep_axis)
        # y: [ep, E_local, C, D], dim 0 the expert shard: global expert id
        # is shard * E_local + local, matching the dispatch layout.
        y = y.reshape(n_experts, capacity, D)
    else:
        y = torch.einsum("ecd,edf->ecf", buf, params.w_in)
        y = F.gelu(y, approximate="tanh")
        y = torch.einsum("ecf,efd->ecd", y, params.w_out)
    # Combine back to token order: [N, D].
    return torch.einsum("nec,ecd->nd", combine, y)
