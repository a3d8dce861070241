"""SPMD pipeline parallelism over a ``pp`` mesh axis.

Port of brpc_tpu/tensor/pipeline.py: the GPipe schedule as one SPMD
program. Every stage runs every one of the M + S - 1 ticks, as the
reference does, and microbatch activations hop stage to stage by
``ppermute``. Which stage a rank is changes values, not the graph: the
stage-dependent choices are ``torch.where`` on a flag, as the reference's
``jnp.where`` guards, so every rank runs the same sends, receives and
psums in the forward and in the backward.
"""
from __future__ import annotations

from typing import Callable

import torch

from brpc_tpu_torch.parallel import collectives


def spmd_pipeline(stage_fn: Callable, stage_params, microbatches, mesh,
                  axis_name: str):
    """Run ``stage_fn(stage_params, x_mb)`` as a pipeline over
    ``axis_name``.

    ``stage_params`` are this rank's stage's layers; ``microbatches``
    [M, ...mb_shape] is the same on every stage. Returns the last stage's
    outputs [M, ...mb_shape] on every stage, broadcast by a masked psum.
    The schedule is the reference's; the send after the last tick, whose
    result no stage reads, is skipped on every stage."""
    n_stages = mesh.size(axis_name)
    stage = mesh.index(axis_name)
    m = microbatches.shape[0]
    n_ticks = m + n_stages - 1
    perm = [(j, (j + 1) % n_stages) for j in range(n_stages)]
    dev = microbatches.device
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == n_stages - 1, device=dev)

    outputs = [torch.zeros_like(microbatches[0]) for _ in range(m)]
    recv = torch.zeros_like(microbatches[0])
    for t in range(n_ticks):
        # Stage 0 feeds from the microbatch queue; later stages consume
        # what the previous stage sent last tick.
        x_in = torch.where(is_first, microbatches[min(t, m - 1)], recv)
        y = stage_fn(stage_params, x_in)
        # The last stage commits microbatch t - (S - 1) when in range.
        out_idx = t - (n_stages - 1)
        if 0 <= out_idx < m:
            outputs[out_idx] = torch.where(is_last, y, outputs[out_idx])
        if t < n_ticks - 1:
            recv = collectives.ppermute(y, mesh, axis_name, perm)
    out = torch.stack(outputs)
    # Only the last stage holds real outputs; zero-mask + psum broadcasts
    # them to every stage.
    return collectives.psum(torch.where(is_last, out, torch.zeros_like(out)),
                            mesh, axis_name)
