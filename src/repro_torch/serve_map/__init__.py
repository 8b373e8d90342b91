"""``repro_torch.serve_map`` — mapping-as-a-service: the online mapper.

A long-lived :class:`MappingService` owns ONE persistent search engine and
ONE persistent :class:`~repro_torch.netmap.cache.MappingCache` and answers
concurrent :class:`MapRequest`\\ s (einsum or whole model, target arch,
objective, per-request deadline) with bounded tail latency:

  * **Hot path** — a process-safe in-memory index over the cache plus a
    service-level deserialized-result index: a warm hit never re-reads the
    JSONL and never re-parses the wire format.
  * **Shape bucketing** — decode traffic's batch x seqlen diversity is
    collapsed onto geometric bucket boundaries (:class:`ShapeBucketer`),
    with a correctness contract: a bucketed mapping is re-validated
    against the exact requested shape before it is served (the request
    executes padded to the bucket — the standard serving contract).
  * **Miss coalescing** — N concurrent requests for the same structural
    key trigger exactly one search; followers await the in-flight result.
  * **Anytime misses** — a deadline'd miss runs through the
    ``core/budget.py`` machinery and always returns a valid mapping with a
    finite certified ``gap_bound`` (roofline floors backstop the search's
    own certificate); a background exact search then warms the cache.

CLI: ``python -m repro_torch.serve_map bench`` (load generator +
latency/SLO report; ``--measure`` runs the CUDA kernels at served tiles)
and ``python -m repro_torch.serve_map serve`` (JSONL request/response loop
over stdin/stdout).  ``measure`` lowers served tiles onto the kernels.
"""
from .bucket import ShapeBucketer
from .request import MapRequest, MapResponse, model_requests
from .service import MappingService, ServiceStats

__all__ = [
    "MapRequest", "MapResponse", "MappingService", "ServiceStats",
    "ShapeBucketer", "model_requests",
]
