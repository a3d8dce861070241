"""fleet — the host half of the reference's fleet observatory.

- :mod:`brpc_tpu_torch.fleet.hist` — mergeable log2 latency histograms;
  merge by adding bucket to bucket, quantiles off the merged buckets.
- :mod:`brpc_tpu_torch.fleet.slo` — declarative objectives evaluated as
  multi-window burn rates (``SloEngine``, ``SloObjective``).

The observatory (a stats scrape of every member over the native
cluster, ``/fleet``) and the autoscaler (a swarm of native servers) are
not ported yet (ROADMAP A12c); ``/fleet`` is not served.
"""
from brpc_tpu_torch.fleet import hist
from brpc_tpu_torch.fleet.slo import SloEngine, SloObjective

__all__ = ["SloEngine", "SloObjective", "hist"]
