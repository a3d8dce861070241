"""Mergeable log2 latency histograms.

Port of brpc_tpu/fleet/hist.py, the twin of the native runtime's bucket
discipline: bucket ``b`` holds latencies in ``[2^(b-1), 2^b)`` ns
(bucket 0 holds 0..1 ns), and 44 buckets cover about 17 s. Histograms
merge exactly by adding bucket to bucket, so a quantile of the merged
buckets is the quantile of all the samples to within one bucket width.
``quantile`` interpolates inside the winning bucket, as the reference
does.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# the native runtime's kNatHistBuckets (nat_stats.h)
NBUCKETS = 44


def bucket_of(ns: int) -> int:
    """The bucket a latency lands in — nat_hist_bucket's twin."""
    if ns <= 0:
        return 0
    b = ns.bit_length()  # floor(log2(ns)) + 1
    return b if b < NBUCKETS else NBUCKETS - 1


def bucket_lo(b: int) -> float:
    return 0.0 if b == 0 else float(1 << (b - 1))


def bucket_hi(b: int) -> float:
    return float(1 << b)


def dense(sparse: Iterable[Sequence[int]], nb: int = NBUCKETS) -> List[int]:
    """Expand the wire form ([[bucket, count], ...]) to a dense list."""
    out = [0] * nb
    for b, c in sparse:
        if 0 <= b < nb:
            out[b] += c
    return out


def merge(*hists: Sequence[int]) -> List[int]:
    """Bucket-wise sum — the exact merge log2 histograms admit."""
    out = [0] * NBUCKETS
    for h in hists:
        for b, c in enumerate(h):
            if b >= NBUCKETS:
                break
            out[b] += c
    return out


def total(buckets: Sequence[int]) -> int:
    return sum(buckets)


def quantile(buckets: Sequence[int], q: float) -> float:
    """Quantile (ns) interpolated within the winning bucket — the exact
    port of nat_hist_quantile (nat_stats.cpp). 0.0 when empty."""
    tot = sum(buckets)
    if tot == 0:
        return 0.0
    q = min(1.0, max(0.0, q))
    target = q * float(tot)
    acc = 0.0
    for b, c in enumerate(buckets):
        if c == 0:
            continue
        if acc + float(c) >= target:
            lo = bucket_lo(b)
            hi = bucket_hi(b)
            frac = (target - acc) / float(c)
            return lo + frac * (hi - lo)
        acc += float(c)
    return float(1 << (len(buckets) - 1))


def fraction_above(buckets: Sequence[int],
                   ceiling_ns: float) -> Tuple[float, int]:
    """(bad_count, total) where bad_count is the (interpolated) number
    of samples above ``ceiling_ns`` — the latency-SLO numerator. The
    bucket straddling the ceiling contributes linearly, matching the
    quantile interpolation, so fraction_above and quantile agree to
    within one bucket width."""
    tot = sum(buckets)
    if tot == 0:
        return 0.0, 0
    bad = 0.0
    for b, c in enumerate(buckets):
        if c == 0:
            continue
        lo = bucket_lo(b)
        hi = bucket_hi(b)
        if lo >= ceiling_ns:
            bad += float(c)
        elif hi > ceiling_ns:
            bad += float(c) * (hi - ceiling_ns) / (hi - lo)
    return bad, tot
