"""Entry points: the flagship forward at the reference's toy config, and the
multi-rank dry run of the SPMD train step.

Counterparts of ``__graft_entry__.entry`` and ``dryrun_multichip``.
``entry`` returns ``(fn, (params, tokens))`` with ``fn(params, tokens) ->
logits``. Both run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from brpc_tpu_torch.device import DeviceLike, resolve_device
from brpc_tpu_torch.parallel.world import DEFAULT_DEADLINE_S, run_ranks
from brpc_tpu_torch.tensor import ModelConfig, forward_local, init_params
from brpc_tpu_torch.tensor.config import MeshSpec
from brpc_tpu_torch.tensor.model import (
    LOGITS_SPEC,
    TOKENS_SPEC,
    make_spmd_forward,
    make_spmd_train_step,
    params_from_numpy,
    shard,
    shard_params,
)

# the reference's forward-parity bound for the dry run (fp32, drop-free)
DRYRUN_FWD_ATOL = 3e-4


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


def _dryrun_specs(n_devices: int):
    """Mesh factorizations to validate. With 8k devices this yields TWO
    meshes that together put every axis — including sp (ring attention)
    and ep (MoE all_to_all) — at size > 1; otherwise the generic
    factorization."""
    if n_devices >= 8 and n_devices % 8 == 0:
        rest = n_devices // 8
        return [
            MeshSpec(dp=2 * rest, tp=2, sp=2),
            MeshSpec(dp=2 * rest, pp=2, ep=2),
        ]
    return [MeshSpec.factorize(n_devices)]


def _dryrun_config(spec: MeshSpec) -> ModelConfig:
    n_experts = max(2, spec.ep)
    return ModelConfig(
        vocab=64,
        d_model=32,
        n_heads=max(2, spec.tp),  # divisible by tp
        d_head=8,
        d_ff=32,
        n_layers=1,  # per pipeline stage
        n_experts=n_experts,
        # fp32 and drop-free expert capacity make sharded == local
        expert_capacity_factor=float(n_experts),
        dtype="float32",
    )


def _dryrun_shapes(spec: MeshSpec):
    """(batch, seq, microbatches): batch divides dp*microbatches, seq sp."""
    n_microbatches = max(1, spec.pp)
    return spec.dp * n_microbatches * 2, spec.sp * 8, n_microbatches


def _dryrun_rank(device, specs, inputs):
    """One rank of the dry run: for each mesh, forward parity against
    forward_local, then four train steps on one batch."""
    out = []
    for i, spec in enumerate(specs):
        cfg = _dryrun_config(spec)
        batch, seq, n_microbatches = _dryrun_shapes(spec)
        mesh, step = make_spmd_train_step(
            cfg, spec, n_microbatches=n_microbatches, lr=0.1)
        if inputs is None:
            gen = torch.Generator(device=device)
            params = init_params(cfg, gen.manual_seed(0), pp_stages=spec.pp,
                                 device=device)
            tokens = torch.randint(0, cfg.vocab, (batch, seq),
                                   generator=gen.manual_seed(1),
                                   device=device, dtype=torch.int32)
        else:
            params = params_from_numpy(inputs[i][0], device=device)
            tokens = torch.as_tensor(inputs[i][1]).to(device)
        labels = torch.roll(tokens, -1, dims=1)

        # Numerical parity: the sharded forward reproduces the
        # single-device forward on this rank's block of the logits.
        expect = shard(forward_local(params, tokens, cfg), LOGITS_SPEC, mesh)
        _, fwd = make_spmd_forward(cfg, spec, n_microbatches=1, mesh=mesh)
        local_params = shard_params(params, mesh)
        local_tokens = shard(tokens, TOKENS_SPEC, mesh)
        local_labels = shard(labels, TOKENS_SPEC, mesh)
        err = float((fwd(local_params, local_tokens) - expect).abs().max())
        if not err <= DRYRUN_FWD_ATOL:
            raise RuntimeError(f"mesh {spec.shape}: sharded forward differs "
                               f"from forward_local by {err}")

        loss0, new_params = step(local_params, local_tokens, local_labels)
        loss0 = float(loss0)
        if not (loss0 == loss0 and loss0 > 0.0):
            raise RuntimeError(f"mesh {spec.shape}: bad loss {loss0}")
        # Training must improve, not merely run: three more steps on the
        # same batch must reduce the loss below step 0's.
        for _ in range(3):
            loss, new_params = step(new_params, local_tokens, local_labels)
        loss = float(loss)
        if not (loss == loss and loss < loss0):
            raise RuntimeError(f"mesh {spec.shape}: loss did not improve: "
                               f"{loss0} -> {loss}")
        out.append({"mesh": spec.shape, "fwd_err": err, "loss0": loss0,
                    "loss3": loss})
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     inputs=None,
                     deadline_s: float = DEFAULT_DEADLINE_S) -> list:
    """The reference's dry run on ``n_devices`` ranks: for each mesh of
    ``_dryrun_specs``, the SPMD forward held against forward_local at
    3e-4, then four SGD steps whose last loss must be below the first.

    On the card each rank needs a card of its own (NCCL; raises with
    fewer cards); ``device="cpu"`` runs gloo ranks. ``inputs``, one
    (params, tokens) pair per mesh (numpy leaves, as ``params_from_numpy``
    takes), replaces the seeded parameters and tokens. Prints one line per
    mesh and returns rank 0's results (every rank holds the same loss)."""
    specs = _dryrun_specs(n_devices)
    results = run_ranks(_dryrun_rank, n_devices, args=(specs, inputs),
                        device=device, deadline_s=deadline_s)
    for r in results[0]:
        print(f"dryrun_multichip ok: mesh={r['mesh']} fwd_parity=allclose "
              f"(max err {r['fwd_err']:.2e}) loss0={r['loss0']:.4f} "
              f"loss3={r['loss3']:.4f}")
    return results[0]
