"""The long-lived mapping service: concurrent queries, bounded tail latency.

One :class:`MappingService` owns ONE persistent search engine and ONE
persistent :class:`~repro.netmap.cache.MappingCache` for its whole
lifetime.  Request flow (see ``docs/architecture.md``)::

    request -> exact hot-index / cache lookup
            -> bucket hot-index / cache lookup   (validated vs exact shape)
            -> miss: coalesce on the structural search key
                 leader   -> budgeted in-thread search (deadline'd)
                             or exact search on the persistent engine
                 follower -> await the in-flight result (up to its own
                             deadline; then a budgeted fallback answer)
            -> truncated answers enqueue a background exact search that
               warms the cache + hot index for the next request

Latency discipline:

  * Warm hits touch only in-memory dicts — the service-level *hot index*
    holds deserialized ``MappingResult``s keyed by cache key, so a hit
    pays neither a JSONL read (the cache's own index guarantees that) nor
    a wire-format parse.
  * Foreground deadline'd misses run an **in-thread serial anytime
    search** (``core/budget.py``): a process pool cannot help a
    millisecond budget, and the persistent pool engine must stay free for
    background exact warms.  Deadline-less misses go through the
    persistent engine (serialized by its run lock — satellite hardening
    in ``core/search.py``).
  * Every deadline'd miss returns a valid mapping with a **finite
    certified** ``gap_bound``: the search's own frontier certificate when
    it is finite, else the sound roofline floor
    (``dse/roofline.einsum_bounds``) — the floor is a provable lower
    bound on any valid mapping's objective, so ``answer / floor`` always
    certifies.

Consistency contracts:

  * Exact-shape hits are **bit-parity** with offline ``tcm_map`` (the
    cache round-trip is bit-exact; truncated results are never cached or
    hot-indexed, so the index only ever holds exact optima).
  * Bucketed answers are re-validated against the bucket einsum rebuilt
    fresh from the exact request (``bucket.validate_bucketed``) before
    every serve.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Dict, List, Optional, Tuple

from ..core.budget import SearchBudget
from ..core.mapper import tcm_map
from ..core.search import (MappingResult, SearchEngine, SerialEngine,
                               make_engine)
from ..dse.roofline import einsum_bounds
from ..netmap.cache import MappingCache, compute_key
from ..obs.tracer import CAT_SERVICE, active

from .bucket import ShapeBucketer, validate_bucketed
from .request import MapRequest, MapResponse, model_requests

__all__ = ["MappingService", "ServiceStats", "NoServableMappingError"]

# floor on the foreground search budget: below this not even a beam dive
# completes, and the deadline is already blown anyway — better to return
# a slightly late certified answer than none
_MIN_SEARCH_S = 0.01


class NoServableMappingError(RuntimeError):
    """The einsum admits no valid mapping on the requested arch."""


def _quantile(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    i = min(len(sorted_xs) - 1, max(0, int(q * (len(sorted_xs) - 1) + 0.5)))
    return sorted_xs[i]


@dataclass
class ServiceStats:
    """Lifetime counters + latency reservoirs (mutated under the service
    lock; read freely — torn reads of ints are harmless for reporting)."""

    requests: int = 0
    exact_hits: int = 0
    bucket_hits: int = 0
    misses: int = 0  # requests that led a search
    coalesced: int = 0  # followers answered by an in-flight search
    fallbacks: int = 0  # followers that timed out into their own answer
    bucketed: int = 0  # answers served under the padding contract
    searches: int = 0  # foreground engine searches (exactly 1 per
    #                    structural miss — the coalescing contract)
    truncated_searches: int = 0
    background_warms: int = 0
    warm_errors: int = 0
    deadline_missed: int = 0
    latencies: deque = field(
        default_factory=lambda: deque(maxlen=100_000))
    hit_latencies: deque = field(
        default_factory=lambda: deque(maxlen=100_000))

    @property
    def hits(self) -> int:
        return self.exact_hits + self.bucket_hits

    def latency_quantiles(self, hits_only: bool = False
                          ) -> Tuple[float, float]:
        """(p50, p99) over the recorded request latencies, seconds."""
        xs = sorted(self.hit_latencies if hits_only else self.latencies)
        return _quantile(xs, 0.50), _quantile(xs, 0.99)

    def to_dict(self) -> dict:
        p50, p99 = self.latency_quantiles()
        hp50, hp99 = self.latency_quantiles(hits_only=True)
        return {
            "requests": self.requests, "exact_hits": self.exact_hits,
            "bucket_hits": self.bucket_hits, "misses": self.misses,
            "coalesced": self.coalesced, "fallbacks": self.fallbacks,
            "bucketed": self.bucketed, "searches": self.searches,
            "truncated_searches": self.truncated_searches,
            "background_warms": self.background_warms,
            "warm_errors": self.warm_errors,
            "deadline_missed": self.deadline_missed,
            "p50_s": p50, "p99_s": p99,
            "hit_p50_s": hp50, "hit_p99_s": hp99,
        }


class _InFlight:
    """One in-flight search: followers wait on the event, then read
    either ``response`` or ``error``."""

    __slots__ = ("event", "response", "error")

    def __init__(self):
        self.event = threading.Event()
        self.response: Optional[MapResponse] = None
        self.error: Optional[BaseException] = None


class MappingService:
    """Answer concurrent :class:`MapRequest`\\ s; see the module doc.

    ``engine`` — the ONE persistent :class:`SearchEngine` used for
    deadline-less misses and background warms (self-made from
    ``workers`` when omitted; closed with the service only when
    self-made).  ``cache`` — a :class:`MappingCache` (self-made under
    ``cache_root`` when omitted).  ``background_warm=False`` disables the
    warm thread (deterministic tests).  ``tracer`` — a ``repro.obs``
    tracer; every request emits ``service``-category events.
    """

    def __init__(self, cache: Optional[MappingCache] = None,
                 cache_root: str = ".tcm_cache",
                 engine: Optional[SearchEngine] = None,
                 workers: Optional[int] = None,
                 bucketer: Optional[ShapeBucketer] = None,
                 tracer=None,
                 background_warm: bool = True):
        self.cache = cache if cache is not None else MappingCache(cache_root)
        self._owns_engine = engine is None
        self.engine = engine if engine is not None else make_engine(
            None, workers)
        # foreground anytime searches run in the request thread on a
        # dedicated serial engine: persistent (so memoized curries stay
        # warm) and safe for concurrent run() (no cross-call state)
        self._serial = SerialEngine(share_incumbents=True)
        self.bucketer = bucketer if bucketer is not None else ShapeBucketer()
        self.tracer = active(tracer)
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._hot: Dict[str, Tuple[MappingResult, float]] = {}
        self._inflight: Dict[str, _InFlight] = {}
        self._warm_q: "Queue" = Queue()
        self._warm_pending: set = set()
        self._warm_thread: Optional[threading.Thread] = None
        self._background_warm = bool(background_warm)
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Idempotent; drains the warm thread, closes a self-made engine."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            warm = self._warm_thread
        if warm is not None:
            self._warm_q.put(None)
            warm.join(timeout=30.0)
        if self._owns_engine:
            self.engine.close()

    def __enter__(self) -> "MappingService":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- the request path --------------------------------------------------

    def map(self, req: MapRequest) -> MapResponse:
        """Serve one request; thread-safe, bounded by ``req.deadline_s``."""
        if self._closed:
            raise RuntimeError("MappingService.map() called after close()")
        t0 = time.perf_counter()
        with self._lock:
            self.stats.requests += 1
        tracer = self.tracer
        if tracer is not None:
            with self._lock:
                depth = len(self._inflight)
            tracer.counter("service_queue", cat=CAT_SERVICE,
                           inflight=depth, warm=len(self._warm_pending))

        exact_key = compute_key(req.einsum, req.arch, req.objective,
                                req.prune_partial)
        resp = self._lookup(exact_key, req, req.einsum, bucketed=False)
        bucket, changed = req.einsum, False
        if resp is None and req.allow_bucketed:
            bucket, changed = self.bucketer.bucket_einsum(req.einsum)
            if changed:
                bkey = compute_key(bucket, req.arch, req.objective,
                                   req.prune_partial)
                resp = self._lookup(bkey, req, bucket, bucketed=True)
        if resp is None:
            search_einsum = bucket if (req.allow_bucketed and changed) \
                else req.einsum
            skey = compute_key(search_einsum, req.arch, req.objective,
                               req.prune_partial)
            resp = self._miss(req, search_einsum, skey,
                              bucketed=(search_einsum is not req.einsum), t0=t0)
        return self._finalize(req, resp, t0)

    def map_model(self, cfg, arch, mode: str = "decode", batch: int = 1,
                  seq: int = 1024, objective: str = "edp",
                  deadline_s: Optional[float] = None,
                  allow_bucketed: bool = True) -> Dict[str, MapResponse]:
        """Map every structurally unique einsum of a model forward pass
        (the online analogue of ``repro.netmap``'s offline planner).
        Returns ``{einsum name: MapResponse}`` in execution order."""
        reqs = model_requests(cfg, arch, mode=mode, batch=batch, seq=seq,
                              objective=objective, deadline_s=deadline_s,
                              allow_bucketed=allow_bucketed)
        return {name: self.map(r) for name, r in reqs.items()}

    # -- internals ---------------------------------------------------------

    def _finalize(self, req: MapRequest, resp: MapResponse,
                  t0: float) -> MapResponse:
        latency = time.perf_counter() - t0
        resp.latency_s = latency
        resp.deadline_met = (req.deadline_s is None
                             or latency <= req.deadline_s)
        hit = resp.source in ("exact-hit", "bucket-hit")
        with self._lock:
            st = self.stats
            st.latencies.append(latency)
            if hit:
                st.hit_latencies.append(latency)
            if resp.bucketed:
                st.bucketed += 1
            if not resp.deadline_met:
                st.deadline_missed += 1
        if self.tracer is not None:
            self.tracer.instant(
                f"request:{resp.source}", cat=CAT_SERVICE,
                einsum=req.einsum.name, latency_s=latency,
                bucketed=resp.bucketed, coalesced=resp.coalesced,
                gap_bound=resp.gap_bound,
                deadline_met=resp.deadline_met)
        return resp

    def _lookup(self, key: str, req: MapRequest, served,
                bucketed: bool) -> Optional[MapResponse]:
        """Hot-index then cache-index lookup; validates bucketed answers
        against the exact request before returning them."""
        with self._lock:
            hot = self._hot.get(key)
        if hot is not None:
            result, gap = hot
        else:
            hit = self.cache.get(served, req.arch, req.objective,
                                 req.prune_partial)
            if hit is None or hit.result is None:
                return None
            result, gap = hit.result, 1.0
            with self._lock:
                self._hot[key] = (result, gap)
        if bucketed:
            validate_bucketed(req.einsum, served, req.arch, result.mapping)
        with self._lock:
            if bucketed:
                self.stats.bucket_hits += 1
            else:
                self.stats.exact_hits += 1
        return MapResponse(result=result, served_einsum=served,
                           source="bucket-hit" if bucketed else "exact-hit",
                           key=key, bucketed=bucketed, gap_bound=gap)

    def _miss(self, req: MapRequest, search_einsum, skey: str,
              bucketed: bool, t0: float) -> MapResponse:
        for _ in range(64):  # bounded retry when a leader errored out
            with self._lock:
                inflight = self._inflight.get(skey)
                leader = inflight is None
                if leader:
                    inflight = _InFlight()
                    self._inflight[skey] = inflight
            if leader:
                try:
                    resp = self._search(req, search_einsum, skey, bucketed,
                                        t0)
                    inflight.response = resp
                except BaseException as e:
                    inflight.error = e
                    raise
                finally:
                    with self._lock:
                        self._inflight.pop(skey, None)
                    inflight.event.set()
                return resp
            # follower: await the in-flight search up to our own deadline
            remaining = (None if req.deadline_s is None
                         else req.deadline_s - (time.perf_counter() - t0))
            if remaining is not None and remaining <= 0:
                return self._fallback(req, search_einsum, skey, bucketed)
            if not inflight.event.wait(timeout=remaining):
                return self._fallback(req, search_einsum, skey, bucketed)
            lead = inflight.response
            if lead is None:
                continue  # the leader errored; retry (maybe as leader)
            if bucketed:
                validate_bucketed(req.einsum, search_einsum, req.arch,
                                  lead.result.mapping)
            with self._lock:
                self.stats.coalesced += 1
            return MapResponse(
                result=lead.result, served_einsum=search_einsum,
                source="coalesced", key=lead.key, bucketed=bucketed,
                coalesced=True, gap_bound=lead.gap_bound)
        raise RuntimeError(
            f"mapping search for {search_einsum.name} kept failing "
            f"(64 in-flight leaders errored)")

    def _certified_gap(self, req: MapRequest, search_einsum, best,
                       stats) -> float:
        """Finite certified gap for an anytime answer: the tighter of the
        search's own frontier certificate and the roofline-floor bound."""
        if not stats.truncated:
            return 1.0
        obj = best.objective(req.objective)
        floor = einsum_bounds(search_einsum, req.arch).objective(
            req.objective)
        roof_gap = obj / floor if floor > 0 else float("inf")
        return max(1.0, min(stats.gap_bound, roof_gap))

    def _search(self, req: MapRequest, search_einsum, skey: str,
                bucketed: bool, t0: float) -> MapResponse:
        """Leader path: exactly one engine search per structural miss."""
        with self._lock:
            self.stats.misses += 1
            self.stats.searches += 1
        deadline = req.deadline_s
        t = time.perf_counter()
        if deadline is None:
            # exact search through the persistent engine (its run lock
            # serializes with background warms)
            best, stats = tcm_map(
                search_einsum, req.arch, req.objective,
                prune_partial=req.prune_partial, collect_sizes=False,
                engine=self.engine, tracer=self.tracer)
            budgeted = False
        else:
            # remaining budget is measured from request arrival, so time
            # already burnt on lookups/coalescing is charged to the search
            remaining = max(deadline - (time.perf_counter() - t0), 0.0)
            budget = SearchBudget(
                deadline_s=max(remaining, _MIN_SEARCH_S))
            best, stats = tcm_map(
                search_einsum, req.arch, req.objective,
                prune_partial=req.prune_partial, collect_sizes=False,
                engine=self._serial, tracer=self.tracer, budget=budget)
            budgeted = True
        t_search = time.perf_counter() - t
        if best is None:
            raise NoServableMappingError(
                f"{search_einsum.name} admits no valid mapping on "
                f"{req.arch.name}")
        gap = self._certified_gap(req, search_einsum, best, stats)
        if stats.truncated:
            with self._lock:
                self.stats.truncated_searches += 1
            # best-so-far served now; warm the cache with the exact
            # optimum in the background so the next request hits
            self._enqueue_warm(search_einsum, req, skey)
        else:
            self.cache.put(search_einsum, req.arch, req.objective, best,
                           stats, t_search=t_search,
                           prune_partial=req.prune_partial)
            with self._lock:
                self._hot[skey] = (best, 1.0)
        if self.tracer is not None:
            self.tracer.instant(
                "search", cat=CAT_SERVICE, einsum=search_einsum.name,
                budgeted=budgeted, truncated=bool(stats.truncated),
                gap_bound=gap, t_search=t_search)
        return MapResponse(result=best, served_einsum=search_einsum,
                           source="search", key=skey, bucketed=bucketed,
                           gap_bound=gap, stats=stats)

    def _fallback(self, req: MapRequest, search_einsum, skey: str,
                  bucketed: bool) -> MapResponse:
        """A follower ran out of deadline waiting: serve its own budgeted
        answer (does NOT count as the structural miss's search — the
        leader's search is still the only one for the key)."""
        with self._lock:
            self.stats.fallbacks += 1
        budget = SearchBudget(deadline_s=_MIN_SEARCH_S)
        best, stats = tcm_map(
            search_einsum, req.arch, req.objective,
            prune_partial=req.prune_partial, collect_sizes=False,
            engine=self._serial, budget=budget)
        if best is None:
            raise NoServableMappingError(
                f"{search_einsum.name} admits no valid mapping on "
                f"{req.arch.name}")
        gap = self._certified_gap(req, search_einsum, best, stats)
        return MapResponse(result=best, served_einsum=search_einsum,
                           source="fallback", key=skey, bucketed=bucketed,
                           gap_bound=gap, stats=stats)

    # -- background warm ---------------------------------------------------

    def _enqueue_warm(self, search_einsum, req: MapRequest,
                      skey: str) -> None:
        if not self._background_warm:
            return
        with self._lock:
            if self._closed or skey in self._warm_pending:
                return
            self._warm_pending.add(skey)
            if self._warm_thread is None:
                self._warm_thread = threading.Thread(
                    target=self._warm_loop, name="tcm-warm", daemon=True)
                self._warm_thread.start()
        self._warm_q.put((search_einsum, req.arch, req.objective,
                          req.prune_partial, skey))

    def _warm_loop(self) -> None:
        while True:
            item = self._warm_q.get()
            if item is None:
                return
            einsum, arch, objective, prune, skey = item
            t = time.perf_counter()
            try:
                best, stats = tcm_map(
                    einsum, arch, objective, prune_partial=prune,
                    collect_sizes=False, engine=self.engine,
                    tracer=self.tracer)
                if best is not None and not stats.truncated:
                    self.cache.put(einsum, arch, objective, best, stats,
                                   t_search=time.perf_counter() - t,
                                   prune_partial=prune)
                    with self._lock:
                        self._hot[skey] = (best, 1.0)
                        self.stats.background_warms += 1
                    if self.tracer is not None:
                        self.tracer.instant(
                            "warm", cat=CAT_SERVICE, einsum=einsum.name,
                            t_search=time.perf_counter() - t)
            except Exception:
                with self._lock:
                    self.stats.warm_errors += 1
            finally:
                with self._lock:
                    self._warm_pending.discard(skey)

    def drain_warm(self, timeout_s: float = 60.0) -> bool:
        """Block until every enqueued background warm finished (tests and
        orderly shutdown); returns False on timeout."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._lock:
                if not self._warm_pending:
                    return True
            time.sleep(0.005)
        return False
