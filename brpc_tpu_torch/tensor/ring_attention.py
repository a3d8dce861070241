"""Causal attention: one device, and sequence-parallel over a ring.

Port of brpc_tpu/tensor/ring_attention.py: ``_block_attend`` (one
online-softmax step), ``ring_attention`` (K/V shards rotate around the
``sp`` ring by ``ppermute`` while each rank accumulates its queries) and
``local_attention`` (the ring of size 1).

The reference's numeric choices are kept on purpose: the scale
``1/sqrt(Dh)`` is rounded to ``q.dtype`` first, the running max ``m``, the
normalizer ``l`` and the output ``o`` are carried in ``q.dtype``, the
additive mask is ``-1e30`` cast to ``q.dtype``, and a fully masked row
(``l == 0``) divides by 1.
"""
from __future__ import annotations

import torch

from brpc_tpu_torch.parallel import collectives

_NEG_INF = -1e30


def _scale(q) -> float:
    """1/sqrt(Dh) as the reference computes it: sqrt rounded to q.dtype,
    then the reciprocal in q.dtype. A Python float (exact in q.dtype), so
    no host-to-device copy stalls the stream."""
    root = torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)
    return float(1.0 / root)


def _block_attend(q, k, v, m, l, o, mask):
    """One online-softmax accumulation step.

    q: [B, Tq, H, Dh]; k, v: [B, Tk, H, Dh]
    m, l: [B, H, Tq] running max / normalizer; o: [B, Tq, H, Dh]
    mask: [Tq, Tk] additive mask (0 or -1e30) or None.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(q)  # [B,H,Tq,Tk]
    if mask is not None:
        s = s + mask[None, None, :, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction.permute(0, 2, 1)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v
    )
    return m_new, l_new, o_new


def _causal_mask(T: int, dtype, device):
    iota = torch.arange(T, device=device)
    return torch.where(iota[:, None] >= iota[None, :], 0.0, _NEG_INF).to(dtype)


def ring_attention(q, k, v, mesh, axis_name: str, causal: bool = True):
    """Attention over a sequence sharded along ``axis_name`` of ``mesh``.

    q, k, v: [B, T_local, H, Dh], this rank's sequence shard; participant
    i holds tokens [i*T_local, (i+1)*T_local). Every participant of the
    ring calls it. The mask of each step is chosen on the host from the
    held shard's origin ``(my_idx - i) % n`` (past: none, own: causal,
    future: all masked), and is added at every step as in the reference,
    so every rank runs the same graph. The last rotation, whose shards the
    reference discards, is not sent."""
    n = mesh.size(axis_name)
    my_idx = mesh.index(axis_name)
    B, T, H, Dh = q.shape
    m = torch.full((B, H, T), _NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    perm = [(j, (j + 1) % n) for j in range(n)]
    masks = None
    if causal:
        masks = {"past": torch.zeros((T, T), dtype=q.dtype, device=q.device),
                 "own": _causal_mask(T, q.dtype, q.device),
                 "future": torch.full((T, T), _NEG_INF, dtype=q.dtype,
                                      device=q.device)}
    k_cur, v_cur = k, v
    for i in range(n):
        src_idx = (my_idx - i) % n  # origin of the held K/V shard
        mask = None
        if causal:
            mask = masks["past" if src_idx < my_idx
                         else "own" if src_idx == my_idx else "future"]
        m, l, o = _block_attend(q, k_cur, v_cur, m, l, o, mask)
        if i < n - 1:
            k_cur = collectives.ppermute(k_cur, mesh, axis_name, perm)
            v_cur = collectives.ppermute(v_cur, mesh, axis_name, perm)
    # Fully-masked rows have l == 0; emit zeros there.
    l = torch.where(l == 0.0, 1.0, l)
    return o / l.permute(0, 2, 1)[..., None]


def local_attention(q, k, v, causal: bool = True):
    """Single-device attention (ring of size 1), the forward's attention and
    the ground truth the SPMD ring is held against."""
    B, T, H, Dh = q.shape
    m = torch.full((B, H, T), _NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    mask = _causal_mask(T, q.dtype, q.device) if causal else None
    m, l, o = _block_attend(q, k, v, m, l, o, mask)
    l = torch.where(l == 0.0, 1.0, l)
    return o / l.permute(0, 2, 1)[..., None]
