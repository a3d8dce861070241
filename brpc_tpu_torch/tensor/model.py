"""Flagship model, single-device forward.

Port of brpc_tpu/tensor/model.py: the parameter layout (``Params``,
``LayerParams``), ``init_params``, ``_rmsnorm``, ``_layer`` with every mesh
axis of size 1, the layer loop ``_stack_scan`` (``lax.scan`` becomes a
Python loop over the stacked ``[L, ...]`` tensors), ``forward_local`` and
``_loss_from_logits``. The SPMD forward and train step wait for the SPMD
slice.

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
from brpc_tpu_torch.tensor.config import ModelConfig
from brpc_tpu_torch.tensor.moe import MoEParams, init_moe, moe_layer
from brpc_tpu_torch.tensor.ring_attention import local_attention


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


def _rmsnorm(x, scale):
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return ((xf / rms) * scale.float()).to(x.dtype)


def _layer(x, lp: LayerParams, cfg: ModelConfig):
    """One block with every mesh axis of size 1: x [B, T, D]."""
    B, T, D = x.shape
    h = _rmsnorm(x, lp.ln1)
    q = (h @ lp.wq).reshape(B, T, cfg.n_heads, cfg.d_head)
    k = (h @ lp.wk).reshape(B, T, cfg.n_heads, cfg.d_head)
    v = (h @ lp.wv).reshape(B, T, cfg.n_heads, cfg.d_head)
    attn = local_attention(q, k, v, causal=True)
    x = x + attn.reshape(B, T, cfg.n_heads * cfg.d_head) @ lp.wo

    h2 = _rmsnorm(x, lp.ln2)
    m = moe_layer(
        lp.moe,
        h2.reshape(B * T, D),
        n_experts=cfg.n_experts,
        capacity_factor=cfg.expert_capacity_factor,
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
