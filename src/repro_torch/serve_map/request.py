"""The service's request/response surface.

A standardized workload API in the spirit of the MLPerf
algorithmic-efficiency spec: a :class:`MapRequest` names *what* to map (an
exact-shape einsum, or a whole model via :func:`model_requests`), *where*
(the target :class:`~repro.core.arch.Arch`), *towards what* (the search
objective) and *by when* (an optional per-request wall-clock deadline).
The :class:`MapResponse` carries the served mapping plus everything a
caller needs to judge it: where the answer came from (exact hit / bucket
hit / coalesced wait / budgeted search), the einsum it was actually
searched for (the bucket, when padded), and a certified optimality
``gap_bound`` (1.0 for exact optima).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core.arch import Arch
from ..core.einsum import Einsum
from ..core.search import MapperStats, MappingResult, einsum_key

__all__ = ["MapRequest", "MapResponse", "model_requests"]


@dataclass(frozen=True)
class MapRequest:
    """One mapping query.

    ``deadline_s`` bounds the *response* latency: on a miss the search runs
    under an anytime budget and returns the best mapping found by the
    deadline with a certified gap (``None`` = run the exact search to
    completion).  ``allow_bucketed`` opts into the padded-shape contract
    (see ``serve_map.bucket``); exact hits are always preferred.
    """

    einsum: Einsum
    arch: Arch
    objective: str = "edp"
    deadline_s: Optional[float] = None
    allow_bucketed: bool = True
    prune_partial: bool = True

    def structural_key(self) -> str:
        """Name-insensitive identity of the exact-shape query."""
        return repr((einsum_key(self.einsum), self.objective,
                     self.prune_partial))


@dataclass
class MapResponse:
    """The served answer plus provenance and certification.

    ``source`` is one of ``"exact-hit"`` / ``"bucket-hit"`` /
    ``"search"`` (this request ran the search) / ``"coalesced"`` (another
    request's in-flight search answered) / ``"fallback"`` (a coalesced
    follower timed out and served its own budgeted answer).
    ``served_einsum`` is what the mapping actually maps — the exact einsum,
    or the bucket einsum when ``bucketed`` (execute padded to it).
    ``gap_bound`` is a certified factor: the true optimum objective for the
    served einsum is provably within ``result.objective(objective) /
    gap_bound``-to-1 of the answer; exact optima carry 1.0.
    """

    result: MappingResult
    served_einsum: Einsum
    source: str
    key: str  # cache key of the served entry
    bucketed: bool = False
    coalesced: bool = False
    gap_bound: float = 1.0
    latency_s: float = 0.0
    deadline_met: bool = True
    stats: Optional[MapperStats] = None


def model_requests(cfg, arch: Arch, mode: str = "decode", batch: int = 1,
                   seq: int = 1024, objective: str = "edp",
                   deadline_s: Optional[float] = None,
                   allow_bucketed: bool = True) -> Dict[str, MapRequest]:
    """One request per *structurally unique* einsum of a model forward pass.

    The extraction and dedup mirror the offline planner
    (``repro.netmap``): repeated layers collapse onto one request, keyed
    here by the first occurrence's einsum name.  Feed the values to
    :meth:`MappingService.map` (or ``map_model``, which does exactly this).
    """
    from ..netmap.extract import extract_einsums

    out: Dict[str, MapRequest] = {}
    seen = set()
    for entry in extract_einsums(cfg, mode=mode, batch=batch, seq=seq):
        k = einsum_key(entry.einsum)
        if k in seen:
            continue
        seen.add(k)
        out[entry.einsum.name] = MapRequest(
            einsum=entry.einsum, arch=arch, objective=objective,
            deadline_s=deadline_s, allow_bucketed=allow_bucketed)
    return out
