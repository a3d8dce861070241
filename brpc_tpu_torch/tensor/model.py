"""Flagship model: a 5D-parallel transformer LM, one process per rank.

Port of brpc_tpu/tensor/model.py: the parameter layout (``Params``,
``LayerParams``), ``init_params``, ``_rmsnorm``, the megatron f and g,
``_layer``, the layer loop ``_stack_scan`` (``lax.scan`` becomes a Python
loop over the stacked ``[L, ...]`` tensors), ``forward_local``,
``_loss_from_logits``, and the SPMD path: ``make_spmd_forward`` and
``make_spmd_train_step``.

The reference's SPMD functions take global arrays and shard them by
``params_pspecs``; here every rank of a world (``parallel.world``) calls
them with its own shards, cut by ``shard_params`` / ``shard`` with the same
specs, and ``unshard_params`` puts the shards of all ranks back together.

``params_from_numpy`` carries the reference's parameters across: its input
is the reference ``Params`` pytree converted leaf by leaf with
``np.asarray``. A bfloat16 leaf is recognised by its dtype name and read
through its 16-bit pattern, so no bfloat16 numpy extension is needed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from brpc_tpu_torch.device import DeviceLike, resolve_device
from brpc_tpu_torch.parallel import collectives, world
from brpc_tpu_torch.tensor.config import MeshSpec, ModelConfig
from brpc_tpu_torch.tensor.moe import MoEParams, init_moe, moe_layer
from brpc_tpu_torch.tensor.pipeline import spmd_pipeline
from brpc_tpu_torch.tensor.ring_attention import (
    local_attention,
    ring_attention,
)


class LayerParams(NamedTuple):
    ln1: torch.Tensor  # [L, D]
    wq: torch.Tensor  # [L, D, H*Dh]
    wk: torch.Tensor  # [L, D, H*Dh]
    wv: torch.Tensor  # [L, D, H*Dh]
    wo: torch.Tensor  # [L, H*Dh, D]
    ln2: torch.Tensor  # [L, D]
    moe: MoEParams  # router [L,D,E], w_in [L,E,D,F], w_out [L,E,F,D]


class Params(NamedTuple):
    embed: torch.Tensor  # [V, D] (tied unembedding)
    layers: LayerParams  # stacked over ALL layers (n_layers * pp)
    final_norm: torch.Tensor  # [D]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                pp_stages: int = 1, device: DeviceLike = None) -> Params:
    """Random parameters with the reference's shapes and scales. Draws on
    the generator's device (a generator on the card keeps a full-width init
    off the host), then moves to ``device``, the card unless the caller
    asks for the CPU."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n_total = cfg.n_layers * pp_stages
    d, dq = cfg.d_model, cfg.d_qkv

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w / math.sqrt(fan_in)).to(device=dev, dtype=dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    embed = dense((cfg.vocab, d), d)
    wq = dense((n_total, d, dq), d)
    wk = dense((n_total, d, dq), d)
    wv = dense((n_total, d, dq), d)
    wo = dense((n_total, dq, d), dq)
    moes = [init_moe(generator, d, cfg.d_ff, cfg.n_experts, dt, dev)
            for _ in range(n_total)]
    moe = MoEParams(*(torch.stack(t) for t in zip(*moes)))
    return Params(
        embed=embed,
        layers=LayerParams(ln1=ones((n_total, d)), wq=wq, wk=wk, wv=wv,
                           wo=wo, ln2=ones((n_total, d)), moe=moe),
        final_norm=ones((d,)),
    )


def _tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch tensors may be written
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


_NESTED = {"layers": LayerParams, "moe": MoEParams}


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """The reference's ``Params`` (any object with the same field names,
    leaves convertible by ``np.asarray``) as port ``Params`` on ``device``."""
    dev = resolve_device(device)

    def conv(cls, node):
        return cls(**{
            f: (conv(_NESTED[f], getattr(node, f)) if f in _NESTED
                else _tensor_from_numpy(getattr(node, f), dev))
            for f in cls._fields
        })

    return conv(Params, tree)


def _tree_map(fn, tree, *rest):
    """fn over the leaves of Params-shaped trees (NamedTuples of leaves)."""
    if hasattr(type(tree), "_fields"):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def _tree_leaves(tree):
    if hasattr(type(tree), "_fields"):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    return [tree]


def params_pspecs(cfg: ModelConfig) -> Params:
    """Per leaf, the mesh axis that shards each dim (the reference's
    PartitionSpecs as tuples): pp the stacked layer dim, tp the head dims,
    ep the expert dim; embed and final_norm replicated."""
    del cfg  # the layout is the same for every configuration
    return Params(
        embed=(None, None),
        layers=LayerParams(
            ln1=("pp", None),
            wq=("pp", None, "tp"),
            wk=("pp", None, "tp"),
            wv=("pp", None, "tp"),
            wo=("pp", "tp", None),
            ln2=("pp", None),
            moe=MoEParams(
                router=("pp", None, None),
                w_in=("pp", "ep", None, None),
                w_out=("pp", "ep", None, None),
            ),
        ),
        final_norm=(None,),
    )


# tokens, labels and logits: batch over dp, sequence over sp
TOKENS_SPEC = ("dp", "sp")
LOGITS_SPEC = ("dp", "sp", None)


def shard(x, spec, mesh: world.RankMesh):
    """This rank's block of a global tensor whose dims are sharded by
    ``spec`` (an axis name or None per leading dim)."""
    for d, axis in enumerate(spec):
        if axis is not None:
            n = mesh.spec.shape[axis]
            size = x.shape[d] // n
            if size * n != x.shape[d]:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"divide by {axis}={n}")
            x = x.narrow(d, mesh.coords[axis] * size, size)
    return x.contiguous()


def shard_params(params: Params, mesh: world.RankMesh) -> Params:
    """This rank's shards of global ``params``, by ``params_pspecs``."""
    return _tree_map(lambda p, spec: shard(p, spec, mesh), params,
                     params_pspecs(None))


def unshard(shards, spec, mesh_spec: MeshSpec):
    """The global array from every rank's block (numpy arrays, in rank
    order); a replicated block is taken from the lowest rank holding it."""
    sizes = tuple(mesh_spec.shape[a] for a in MeshSpec.AXIS_NAMES)
    first = shards[0]
    shape = tuple(first.shape[d] * (mesh_spec.shape[spec[d]]
                                    if d < len(spec) and spec[d] else 1)
                  for d in range(first.ndim))
    out = np.empty(shape, dtype=first.dtype)
    filled = set()
    for rank, block in enumerate(shards):
        coords = dict(zip(MeshSpec.AXIS_NAMES,
                          np.unravel_index(rank, sizes)))
        slot = tuple(int(coords[a]) if a else 0 for a in spec)
        if slot in filled:
            continue
        filled.add(slot)
        index = tuple(slice(i * n, (i + 1) * n)
                      for i, n in zip(slot, block.shape))
        out[index] = block
    return out


def unshard_params(shards, mesh_spec: MeshSpec) -> Params:
    """Global Params (numpy leaves) from every rank's local Params."""
    specs = params_pspecs(None)
    return _tree_map(lambda spec, *blocks: unshard(blocks, spec, mesh_spec),
                     specs, *shards)


def _rmsnorm(x, scale):
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return ((xf / rms) * scale.float()).to(x.dtype)


class _IdentityFwdPsumBwd(torch.autograd.Function):
    """Megatron 'f': activations replicated forward; the cotangent psum'd
    backward so replicated-weight grads stay identical across tp."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives._reduce(g, ctx.mesh, ctx.axis), None, None


class _PsumFwdIdentityBwd(torch.autograd.Function):
    """Megatron 'g': partial outputs summed forward; the cotangent passes
    through."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return collectives._reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _layer(x, lp: LayerParams, cfg: ModelConfig, mesh=None,
           tp_axis=None, sp_axis=None, ep_axis=None, n_heads_local=None):
    """One block on x [B, T, D], this rank's activation shard. With every
    axis None it is the single-device block."""
    B, T, D = x.shape
    heads = cfg.n_heads if n_heads_local is None else n_heads_local
    h = _rmsnorm(x, lp.ln1)
    if tp_axis is not None:
        h = _IdentityFwdPsumBwd.apply(h, mesh, tp_axis)
    q = (h @ lp.wq).reshape(B, T, heads, cfg.d_head)
    k = (h @ lp.wk).reshape(B, T, heads, cfg.d_head)
    v = (h @ lp.wv).reshape(B, T, heads, cfg.d_head)
    if sp_axis is not None:
        attn = ring_attention(q, k, v, mesh, sp_axis, causal=True)
    else:
        attn = local_attention(q, k, v, causal=True)
    y = attn.reshape(B, T, heads * cfg.d_head) @ lp.wo
    if tp_axis is not None:
        y = _PsumFwdIdentityBwd.apply(y, mesh, tp_axis)
    x = x + y

    h2 = _rmsnorm(x, lp.ln2)
    m = moe_layer(
        lp.moe,
        h2.reshape(B * T, D),
        n_experts=cfg.n_experts,
        capacity_factor=cfg.expert_capacity_factor,
        mesh=mesh,
        ep_axis=ep_axis,
    )
    return x + m.reshape(B, T, D)


def _stack_scan(layers: LayerParams, x, layer_fn):
    """Run the stacked layers in order (the reference's ``lax.scan``)."""
    for i in range(layers.ln1.shape[0]):
        lp = LayerParams(
            *(t[i] for t in layers[:-1]),
            moe=MoEParams(*(t[i] for t in layers.moe)),
        )
        x = layer_fn(x, lp)
    return x


def forward_local(params: Params, tokens, cfg: ModelConfig):
    """Single-device forward on the device the params are on: tokens
    [B, T] int -> float32 logits [B, T, vocab]."""
    tokens = tokens.to(params.embed.device)
    x = F.embedding(tokens, params.embed)
    x = _stack_scan(params.layers, x, lambda c, lp: _layer(c, lp, cfg))
    x = _rmsnorm(x, params.final_norm)
    return (x @ params.embed.T).float()


def _loss_from_logits(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.sum()


def make_spmd_forward(cfg: ModelConfig, spec: MeshSpec,
                      n_microbatches: int = 1, mesh: world.RankMesh = None):
    """Forward over the five-axis mesh. Every rank of the world calls it
    (building ``mesh`` when none is given) and gets (mesh, fn): fn(local
    params, local tokens [B/dp, T/sp]) -> local float32 logits
    [B/dp, T/sp, vocab]."""
    mesh = mesh if mesh is not None else world.RankMesh(spec)
    return mesh, _make_spmd_fwd_inner(cfg, mesh, n_microbatches)


def _make_spmd_fwd_inner(cfg: ModelConfig, mesh: world.RankMesh,
                         n_microbatches: int):
    spec = mesh.spec
    tp_axis = "tp" if spec.tp > 1 else None
    sp_axis = "sp"  # always ring over sp (a ring of one is the identity)
    ep_axis = "ep" if spec.ep > 1 else None
    n_heads_local = cfg.n_heads // spec.tp
    if n_heads_local * spec.tp != cfg.n_heads:
        raise ValueError("n_heads must divide by tp")
    if ep_axis is not None and cfg.n_experts % spec.ep:
        raise ValueError("n_experts must divide by ep")

    def layer_fn(x, lp):
        return _layer(x, lp, cfg, mesh, tp_axis, sp_axis, ep_axis,
                      n_heads_local)

    def stage_fn(stage_layers, x_mb):
        return _stack_scan(stage_layers, x_mb, layer_fn)

    def fwd(params: Params, tokens):
        B, T = tokens.shape  # local shard: [B/dp, T/sp]
        x = F.embedding(tokens, params.embed)
        if B % n_microbatches:
            raise ValueError("local batch must divide by microbatches")
        mb = B // n_microbatches
        x = x.reshape(n_microbatches, mb, T, cfg.d_model)
        if spec.pp > 1:
            out = spmd_pipeline(stage_fn, params.layers, x, mesh, "pp")
        else:  # the reference's vmap over microbatches
            out = torch.stack([stage_fn(params.layers, x[i])
                               for i in range(n_microbatches)])
        x = out.reshape(B, T, cfg.d_model)
        x = _rmsnorm(x, params.final_norm)
        return (x @ params.embed.T).float()

    return fwd


def make_spmd_train_step(cfg: ModelConfig, spec: MeshSpec,
                         n_microbatches: int = 1, lr: float = 1e-2,
                         mesh: world.RankMesh = None):
    """Full training step over the five-axis mesh: forward, backward,
    gradient merge (psum over dp+sp; over pp too for leaves not stacked
    over pp), SGD. Returns (mesh, step) with step(local params, local
    tokens, local labels) -> (loss, new local params).

    The loss psum's transpose is a psum, as in the reference, so the
    gradient that reaches the update is scaled by dp*sp (and expert
    weights by ep): ROADMAP queue C #6."""
    mesh = mesh if mesh is not None else world.RankMesh(spec)
    fwd = _make_spmd_fwd_inner(cfg, mesh, n_microbatches)
    pp_stacked = [s[0] == "pp" for s in _tree_leaves(params_pspecs(cfg))]
    n_global_tokens_factor = spec.dp * spec.sp  # local count * this = global

    def step(params: Params, tokens, labels):
        params = _tree_map(lambda p: p.detach().requires_grad_(), params)
        logits = fwd(params, tokens)
        local = _loss_from_logits(logits, labels)
        total = collectives.psum(local, mesh, ("dp", "sp"))
        loss = total / (tokens.numel() * n_global_tokens_factor)
        leaves = _tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        new = []
        with torch.no_grad():
            for p, g, stacked in zip(leaves, grads, pp_stacked):
                g = collectives._reduce(g, mesh, ("dp", "sp"))
                if not stacked:  # partial contributions per stage
                    g = collectives._reduce(g, mesh, "pp")
                new.append(p - lr * g.float().to(p.dtype))
        it = iter(new)
        return loss.detach(), _tree_map(lambda _: next(it), params)

    return mesh, step
