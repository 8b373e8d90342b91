"""Load generator: mixed decode-shape traffic against a MappingService.

Models the shape diversity an online mapper actually sees: every decode
step grows kv_len by one and batches churn, so the request stream draws
(batch, kv_len) pairs from a seeded RNG and asks for the attention +
projection einsums of a real model config at those shapes.  Three phases:

  1. **Warmup** (optional) — one deadline-less request per unique bucket,
     issued sequentially, so the timed phase measures the steady state the
     SLO gates are about (warm hits must be sub-millisecond).
  2. **Stampede** — every client thread issues the *same* cold shape
     simultaneously (barrier-released): the classic thundering herd.  With
     coalescing working, exactly one search runs and ``clients - 1``
     followers ride it — this is what the coalescing-ratio gate measures.
  3. **Timed** — the clients drain a shared shuffled pool of deadline'd
     requests and the report aggregates latency quantiles, deadline
     compliance and throughput.

The report is plain dict-of-scalars so ``python -m repro_torch.serve_map
bench`` can JSON-dump it and CI can gate on it.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..core.arch import Arch
from ..core.search import einsum_key
from ..netmap.extract import extract_einsums

from .request import MapRequest
from .service import MappingService

__all__ = ["build_request_pool", "run_loadgen"]

# the decode-step ops whose shapes actually vary with traffic
_DEFAULT_OPS = ("qk", "av", "q_proj")


def build_request_pool(cfg, arch: Arch, *, requests: int = 200,
                       seed: int = 0, deadline_s: Optional[float] = 0.25,
                       objective: str = "edp",
                       batch_choices: Sequence[int] = (1, 2, 4, 8),
                       seq_range: Sequence[int] = (16, 1024),
                       ops: Sequence[str] = _DEFAULT_OPS,
                       ) -> List[MapRequest]:
    """``requests`` deadline'd MapRequests over RNG-drawn decode shapes.

    Shapes draw ``batch`` from ``batch_choices`` and ``kv_len`` uniformly
    from ``seq_range``; each draw contributes the layer-0 ``ops`` einsums
    of ``cfg``'s decode step.  Deterministic for a fixed ``seed``.
    """
    rng = random.Random(seed)
    memo: Dict[tuple, List] = {}
    pool: List[MapRequest] = []
    while len(pool) < requests:
        batch = rng.choice(list(batch_choices))
        seq = rng.randint(int(seq_range[0]), int(seq_range[1]))
        shape = (batch, seq)
        if shape not in memo:
            memo[shape] = [
                e.einsum for e in extract_einsums(
                    cfg, mode="decode", batch=batch, seq=seq)
                if e.layer == 0 and e.op in ops]
        for ein in memo[shape]:
            if len(pool) >= requests:
                break
            pool.append(MapRequest(
                einsum=ein, arch=arch, objective=objective,
                deadline_s=deadline_s, allow_bucketed=True))
    rng.shuffle(pool)
    return pool


def _unique_bucket_requests(service: MappingService,
                            pool: Sequence[MapRequest]) -> List[MapRequest]:
    seen, out = set(), []
    for req in pool:
        bucket, _ = service.bucketer.bucket_einsum(req.einsum)
        k = (einsum_key(bucket), req.objective, req.prune_partial)
        if k in seen:
            continue
        seen.add(k)
        out.append(MapRequest(einsum=req.einsum, arch=req.arch,
                              objective=req.objective, deadline_s=None,
                              allow_bucketed=True))
    return out


def run_loadgen(service: MappingService, cfg, arch: Arch, *,
                requests: int = 200, clients: int = 8, seed: int = 0,
                deadline_s: Optional[float] = 0.25, objective: str = "edp",
                batch_choices: Sequence[int] = (1, 2, 4, 8),
                seq_range: Sequence[int] = (16, 1024),
                ops: Sequence[str] = _DEFAULT_OPS,
                warmup: bool = True, stampede: bool = True) -> dict:
    """Drive ``service`` with mixed decode-shape traffic; return the report.

    The returned dict carries the timed-phase SLO numbers (`p50_ms`,
    ``p99_ms``, ``hit_*`` variants, ``deadline_met_ratio``, ``rps``), the
    stampede's ``coalesce_ratio`` (followers / herd size), shape-collapse
    counts, and the service's lifetime counters under ``"service"``.
    """
    pool = build_request_pool(
        cfg, arch, requests=requests, seed=seed, deadline_s=deadline_s,
        objective=objective, batch_choices=batch_choices,
        seq_range=seq_range, ops=ops)
    uniq = _unique_bucket_requests(service, pool)
    if warmup:
        for req in uniq:
            service.map(req)

    results: List[dict] = []
    res_lock = threading.Lock()
    errors: List[BaseException] = []

    # stampede: one cold shape (outside seq_range so warmup never saw its
    # bucket) requested by every client at once
    herd_req = None
    if stampede:
        cold_seq = service.bucketer.bucket_value(
            int(seq_range[1])) * 2 + 3  # strictly inside a fresh bucket
        herd = [e.einsum for e in extract_einsums(
            cfg, mode="decode", batch=int(batch_choices[0]), seq=cold_seq)
            if e.layer == 0 and e.op == ops[0]]
        herd_req = MapRequest(einsum=herd[0], arch=arch,
                              objective=objective, deadline_s=None,
                              allow_bucketed=True)
    searches_before = service.stats.searches
    coalesced_before = service.stats.coalesced

    idx = {"i": 0}
    barrier = threading.Barrier(clients)

    def worker():
        try:
            barrier.wait()
            if herd_req is not None:
                service.map(herd_req)
            while True:
                with res_lock:
                    i = idx["i"]
                    if i >= len(pool):
                        return
                    idx["i"] = i + 1
                resp = service.map(pool[i])
                row = {"latency_s": resp.latency_s, "source": resp.source,
                       "deadline_met": resp.deadline_met,
                       "gap_bound": resp.gap_bound}
                with res_lock:
                    results.append(row)
        except BaseException as e:  # surfaced to the caller below
            with res_lock:
                errors.append(e)

    threads = [threading.Thread(target=worker, name=f"loadgen-{i}")
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]

    lat = sorted(r["latency_s"] for r in results)
    hit_lat = sorted(r["latency_s"] for r in results
                     if r["source"] in ("exact-hit", "bucket-hit"))
    met = sum(1 for r in results if r["deadline_met"])

    def q(xs, p):
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, max(0, int(p * (len(xs) - 1) + 0.5)))]

    herd_searches = service.stats.searches - searches_before
    herd_coalesced = service.stats.coalesced - coalesced_before
    coalesce_ratio = (herd_coalesced / max(1, herd_coalesced + herd_searches)
                      if stampede else 0.0)
    n = len(results)
    return {
        "requests": n,
        "clients": clients,
        "unique_shapes": len({einsum_key(r.einsum) for r in pool}),
        "unique_buckets": len(uniq),
        "deadline_s": deadline_s,
        "elapsed_s": elapsed,
        "rps": n / elapsed if elapsed > 0 else 0.0,
        "p50_ms": q(lat, 0.50) * 1e3,
        "p99_ms": q(lat, 0.99) * 1e3,
        "hit_p50_ms": q(hit_lat, 0.50) * 1e3,
        "hit_p99_ms": q(hit_lat, 0.99) * 1e3,
        "hits": len(hit_lat),
        "deadline_met_ratio": met / n if n else 1.0,
        "stampede_searches": herd_searches,
        "stampede_coalesced": herd_coalesced,
        "coalesce_ratio": coalesce_ratio,
        "max_gap_bound": max((r["gap_bound"] for r in results), default=1.0),
        "service": service.stats.to_dict(),
    }
