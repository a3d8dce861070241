"""Causal attention for the single-device forward.

Port of brpc_tpu/tensor/ring_attention.py: ``_block_attend`` (one
online-softmax step) and ``local_attention`` (the ring of size 1). The
sequence-sharded ``ring_attention`` waits for the SPMD slice.

The reference's numeric choices are kept on purpose: the scale
``1/sqrt(Dh)`` is rounded to ``q.dtype`` first, the running max ``m``, the
normalizer ``l`` and the output ``o`` are carried in ``q.dtype``, the
additive mask is ``-1e30`` cast to ``q.dtype``, and a fully masked row
(``l == 0``) divides by 1.
"""
from __future__ import annotations

import torch

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


def local_attention(q, k, v, causal: bool = True):
    """Single-device attention (ring of size 1), the forward's attention and
    the ground truth the SPMD ring will be held against."""
    B, T, H, Dh = q.shape
    m = torch.full((B, H, T), _NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    mask = _causal_mask(T, q.dtype, q.device) if causal else None
    m, l, o = _block_attend(q, k, v, m, l, o, mask)
    l = torch.where(l == 0.0, 1.0, l)
    return o / l.permute(0, 2, 1)[..., None]
