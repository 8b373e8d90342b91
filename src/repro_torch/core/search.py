"""Parallel full-mapspace search engine (executor layer).

The TCM driver (``mapper.tcm_map``) materializes the dataplacement x
dataflow-skeleton cross-product as :class:`WorkUnit` records and dispatches
them through a :class:`SearchEngine`.  Engines run a *two-phase global
branch-and-bound* by default (``share_incumbents=True``): phase 1 beam-dives
every unit (:func:`run_seed_unit`) to seed one global incumbent objective,
phase 2 runs the full explorations against it with every finished unit
tightening the bound — sound pruning, so optima are value-identical to the
per-unit-incumbent search (``share_incumbents=False``), just found with far
less exploration.  Two backends are provided:

  * :class:`SerialEngine` — runs every unit in the calling process, in unit
    order; the incumbent tightens sequentially, so runs are exactly
    reproducible.  The default (tests and small searches use it; with
    sharing off it reproduces the historical single-loop behavior
    bit-for-bit).
  * :class:`ProcessPoolEngine` — fans units out over a
    ``concurrent.futures.ProcessPoolExecutor`` with a configurable worker
    count, publishing the global incumbent through a shared
    ``multiprocessing.Value`` (lock-free reads once per branch-and-bound
    step, CAS-style tighten on unit completion).  Results come back *in
    unit order* (``executor.map`` preserves ordering), so the driver's
    merge is order-identical to the serial backend; prune counters depend
    on worker scheduling, the selected optimum's values do not.

Each unit curries the model once (``CurriedModel``), explores tile shapes
with partial-tile-shape pruning, and returns a picklable
``(candidate, stats)`` record.  Stats merge exactly: counters are integer
sums, mapspace-size accumulators are kept in linear space and only converted
to log10 at :meth:`MapperStats.finalize`, and phase timings are per-phase
sums (in the process backend they are summed *across* workers, i.e. they
measure aggregate CPU time, not wall time — wall time is ``t_total``).

A memoization layer (``functools.lru_cache``) backs the enumeration entry
points so repeated einsum shapes — common across the per-model configs in
``repro.configs`` and across benchmark tables that share workloads — do not
redo dataplacement/dataflow enumeration or model currying.  Cache keys are
*structural*: two einsums that differ only in ``name`` share cache entries.
"""
from __future__ import annotations

import functools
import math
import multiprocessing as mp
import os
import threading
import time
from concurrent.futures import (BrokenExecutor, ProcessPoolExecutor,
                                as_completed)
from contextlib import nullcontext
from dataclasses import asdict, dataclass, field, fields
from functools import lru_cache
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from ..obs.tracer import Tracer, active
from .arch import Arch
from .budget import SharedBudgetMeter, ensure_meter
from .dataflow import enumerate_skeletons
from .dataplacement import Dataplacement, enumerate_dataplacements
from .einsum import Einsum
from .fusion import (FusedSkeleton, FusedWorkload, workload_from_key,
                     workload_key)
from .looptree import Mapping
from .model import CurriedModel, FusedCurriedModel
from .tileshape import beam_objective, explore

# --------------------------------------------------------------------------
# Statistics (moved here from mapper.py so both layers can share them;
# mapper re-exports for backwards compatibility).
# --------------------------------------------------------------------------


@dataclass
class MapperStats:
    # log10 mapspace sizes (Table II / Fig 6); set by ``finalize``
    log10_total: float = 0.0
    log10_after_df_pruning: float = 0.0  # dataflow pruning only
    log10_after_loop_pruning: float = 0.0  # + tile-shape (loop) pruning
    log10_evaluated: float = 0.0  # + partial tile-shape pruning
    n_dataplacements: int = 0
    n_skeletons: int = 0  # pruned |DF| summed over dataplacements
    n_final_evals: int = 0
    n_expanded: int = 0
    n_pruned_dominated: int = 0
    n_pruned_invalid: int = 0
    n_pruned_bound: int = 0
    # phase runtimes (Fig 8 breakdown).  Under the process backend t_curry /
    # t_tileshape are summed across workers (aggregate CPU seconds).
    t_dataplacement: float = 0.0
    t_dataflow: float = 0.0
    t_curry: float = 0.0
    t_tileshape: float = 0.0
    t_total: float = 0.0
    # linear-space mapspace-size accumulators (units of 10**300-capped logs);
    # kept linear so partial stats merge exactly, converted by ``finalize``
    sum_total: float = 0.0
    sum_df_pruned: float = 0.0
    sum_loop_pruned: float = 0.0
    # resilience (anytime budgets + fault-tolerant execution).  gap_bound is
    # a *certificate*: best returned objective / sound global lower bound —
    # 1.0 when the search ran to completion (exact), inf when nothing can
    # be certified (no mapping returned, or a unit was quarantined).
    truncated: bool = False
    gap_bound: float = 1.0
    n_truncated_units: int = 0
    n_retried_units: int = 0  # pool units re-run after a worker death
    n_quarantined_units: int = 0  # poison units given up on (repro written)
    n_resumed_units: int = 0  # units served from a checkpoint journal

    def merge(self, other: "MapperStats") -> None:
        """Accumulate another (partial) stats record into this one.

        Everything is additive: integer counters and linear mapspace-size
        accumulators merge exactly; timings become per-phase sums.  The
        log10_* fields are NOT merged — call :meth:`finalize` once after all
        partial records are in.
        """
        self.n_dataplacements += other.n_dataplacements
        self.n_skeletons += other.n_skeletons
        self.n_final_evals += other.n_final_evals
        self.n_expanded += other.n_expanded
        self.n_pruned_dominated += other.n_pruned_dominated
        self.n_pruned_invalid += other.n_pruned_invalid
        self.n_pruned_bound += other.n_pruned_bound
        self.t_dataplacement += other.t_dataplacement
        self.t_dataflow += other.t_dataflow
        self.t_curry += other.t_curry
        self.t_tileshape += other.t_tileshape
        self.sum_total += other.sum_total
        self.sum_df_pruned += other.sum_df_pruned
        self.sum_loop_pruned += other.sum_loop_pruned
        # truncation ORs (any truncated part leaves the whole truncated) and
        # the weakest gap certificate governs the merged record
        self.truncated = self.truncated or other.truncated
        self.gap_bound = max(self.gap_bound, other.gap_bound)
        self.n_truncated_units += other.n_truncated_units
        self.n_retried_units += other.n_retried_units
        self.n_quarantined_units += other.n_quarantined_units
        self.n_resumed_units += other.n_resumed_units

    def to_dict(self) -> Dict[str, Any]:
        """Canonical JSON-safe serialization.

        The single wire format for every consumer of stats — benchmark
        ``--json`` payloads, ``repro.dse`` reports, netmap cache records —
        so field additions propagate everywhere at once.  Inverse:
        :func:`stats_from_dict`.
        """
        return asdict(self)

    def finalize(self) -> None:
        """Convert linear accumulators to the published log10 fields."""
        self.log10_total = math.log10(max(self.sum_total, 1e-300)) + 300
        self.log10_after_df_pruning = (
            math.log10(max(self.sum_df_pruned, 1e-300)) + 300)
        self.log10_after_loop_pruning = (
            math.log10(max(self.sum_loop_pruned, 1e-300)) + 300)
        # "evaluated" = every point where the (curried) model is applied to a
        # candidate: partial criteria/bound evaluations + final full
        # evaluations (the paper counts tile-shape-only model invocations the
        # same way).
        self.log10_evaluated = math.log10(max(self.n_expanded, 1))


_STATS_FIELDS = frozenset(f.name for f in fields(MapperStats))


def stats_from_dict(d: Dict[str, Any]) -> MapperStats:
    """Rebuild a :class:`MapperStats` from :meth:`MapperStats.to_dict`
    output, tolerating unknown keys (cache records written by newer or
    older versions round-trip on the shared field set)."""
    return MapperStats(**{k: v for k, v in d.items() if k in _STATS_FIELDS})


@dataclass
class MappingResult:
    mapping: Mapping
    energy: float
    latency: float
    edp: float

    def objective(self, kind: str) -> float:
        return {"edp": self.edp, "energy": self.energy,
                "latency": self.latency}[kind]


# --------------------------------------------------------------------------
# Memoized enumeration / currying
# --------------------------------------------------------------------------

EinsumKey = Tuple[tuple, Tuple[Tuple[str, int], ...]]


def einsum_key(einsum: Einsum) -> EinsumKey:
    """Structural cache key: tensors + rank shapes, ignoring ``name``."""
    return (einsum.tensors, tuple(sorted(einsum.rank_shapes.items())))


# bounded (was maxsize=None): long multi-model netmap sweeps touch an
# unbounded stream of distinct einsum shapes, and each key here anchors the
# much heavier downstream memos — see clear_search_caches()
@lru_cache(maxsize=4096)
def _einsum_from_key(key: EinsumKey) -> Einsum:
    return Einsum(name="<cached>", tensors=key[0], rank_shapes=dict(key[1]))


@lru_cache(maxsize=512)
def _dataplacements_cached(key: EinsumKey, arch: Arch
                           ) -> Tuple[Dataplacement, ...]:
    return tuple(enumerate_dataplacements(_einsum_from_key(key), arch))


@lru_cache(maxsize=4096)
def _skeletons_cached(key: EinsumKey, arch: Arch, dp: Dataplacement
                      ) -> Tuple[Mapping, ...]:
    return tuple(enumerate_skeletons(_einsum_from_key(key), arch, dp))


@lru_cache(maxsize=512)
def _curried_cached(key: EinsumKey, arch: Arch, skeleton: Mapping
                    ) -> CurriedModel:
    return CurriedModel(_einsum_from_key(key), arch, skeleton)


def cached_dataplacements(einsum: Einsum, arch: Arch
                          ) -> Tuple[Dataplacement, ...]:
    return _dataplacements_cached(einsum_key(einsum), arch)


def cached_skeletons(einsum: Einsum, arch: Arch, dp: Dataplacement
                     ) -> Tuple[Mapping, ...]:
    return _skeletons_cached(einsum_key(einsum), arch, dp)


@lru_cache(maxsize=256)
def _fused_curried_cached(wkey, arch: Arch, skeleton: FusedSkeleton
                          ) -> FusedCurriedModel:
    return FusedCurriedModel(workload_from_key(wkey), arch, skeleton)


def cached_curried_model(einsum, arch: Arch, skeleton):
    """Memoized currying; dispatches on workload kind (einsum vs fused
    group), so the engines and their worker entry points run fused work
    units without change."""
    if isinstance(einsum, FusedWorkload):
        return _fused_curried_cached(workload_key(einsum), arch, skeleton)
    return _curried_cached(einsum_key(einsum), arch, skeleton)


def clear_search_caches() -> None:
    """Drop all memoized enumeration/currying state.

    Called from :meth:`SearchEngine.close` so long multi-model sweeps
    (``repro.netmap`` over many configs) release the curried models and
    enumerations of finished batches instead of growing without bound; the
    persistent on-disk ``MappingCache`` carries cross-run reuse.
    """
    _einsum_from_key.cache_clear()
    _dataplacements_cached.cache_clear()
    _skeletons_cached.cache_clear()
    _curried_cached.cache_clear()
    _fused_curried_cached.cache_clear()


# historical name (benchmark hygiene call sites)
clear_caches = clear_search_caches


# --------------------------------------------------------------------------
# Fault injection (testing only)
# --------------------------------------------------------------------------

# Deterministic fault plan for the resilience tests/CI smoke
# (``repro.testing.faults``): loaded lazily from the file named by
# $TCM_FAULT_PLAN — either here on first unit in this process, or eagerly by
# the pool initializer (which captures the env var at pool-creation time, so
# plans installed after a forkserver has started still reach new workers).
# With no plan installed the per-unit cost is one global read + one branch.
_FAULT_PLAN = None
_FAULT_PLAN_LOADED = False


def _set_fault_plan(path: Optional[str]) -> None:
    global _FAULT_PLAN, _FAULT_PLAN_LOADED
    _FAULT_PLAN_LOADED = True
    if not path:
        _FAULT_PLAN = None
        return
    from ..testing.faults import load_plan
    _FAULT_PLAN = load_plan(path)


def reset_fault_plan() -> None:
    """Forget any loaded plan so the next unit re-reads $TCM_FAULT_PLAN
    (tests install/remove plans mid-process)."""
    global _FAULT_PLAN, _FAULT_PLAN_LOADED
    _FAULT_PLAN = None
    _FAULT_PLAN_LOADED = False


def _fault_hook(unit_index: int) -> None:
    global _FAULT_PLAN_LOADED
    if not _FAULT_PLAN_LOADED:
        _set_fault_plan(os.environ.get("TCM_FAULT_PLAN"))
    if _FAULT_PLAN is not None:
        _FAULT_PLAN.fire(unit_index)


# --------------------------------------------------------------------------
# Work units
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkUnit:
    """One independent search task.

    For a single einsum this is one (dataplacement, dataflow-skeleton)
    pair; for a fusion group, ``einsum`` is a
    :class:`~repro.core.fusion.FusedWorkload` and ``skeleton`` a
    :class:`~repro.core.fusion.FusedSkeleton` (pin level + per-member
    sub-skeletons).  ``cached_curried_model`` dispatches on the kind, so
    the engines — incumbent sharing, beam seeding, compiled criterion
    kernels — run both unchanged.

    ``arch`` is carried explicitly per unit (not per batch): one engine
    ``run`` may legally mix units from *different* architecture points, as
    ``tcm_map_best_arch`` and the ``repro.dse`` explorer do.  The only
    batching contract incumbent sharing imposes is that all units in one
    ``run`` optimize the same workload under the same ``objective`` — the
    shared bound is an objective value, comparable across architectures but
    not across einsums.
    """

    index: int  # position in the driver's enumeration order
    einsum: Union[Einsum, FusedWorkload]
    arch: Arch
    skeleton: Union[Mapping, FusedSkeleton]
    objective: str = "edp"
    prune_partial: bool = True


@dataclass
class WorkResult:
    """Picklable outcome of one work unit: local optimum + partial stats.

    ``events`` carries the worker-side trace buffer when the run is traced
    (pool workers cannot write to the driver's tracer); the engine folds the
    buffers into the master tracer *in unit order* and resets the field, so
    the merged stream layout is deterministic regardless of worker
    scheduling.  ``None`` on untraced runs.

    ``truncated``/``lower_bound`` carry the anytime-search certificate: a
    truncated unit's ``candidate`` is its best-so-far mapping (or None) and
    ``lower_bound`` soundly bounds every valid completion of the unit's
    unexplored subtrees (see ``tileshape._truncate``); drivers fold the
    per-unit bounds into ``MapperStats.gap_bound``.
    """

    index: int
    candidate: Optional[MappingResult]
    stats: MapperStats
    events: Optional[List[dict]] = None
    truncated: bool = False
    lower_bound: float = float("inf")


def run_seed_unit(unit: WorkUnit) -> Tuple[int, float, float, float]:
    """Phase-1 task: beam-dive one unit for an incumbent objective.

    Returns ``(index, objective_upper_bound, curry_seconds, dive_seconds)``
    — the bound is ``inf`` when the dive finds no complete valid mapping.
    Currying and diving are timed separately so the engine can book them
    into the matching ``MapperStats`` phases (phase 2 re-times the curry on
    a warm cache, so without this the whole curry cost would masquerade as
    tile-shape time in the fig8 breakdown).  Module-level so the process
    backend can map it across workers.
    """
    if not unit.prune_partial:
        return (unit.index, float("inf"), 0.0, 0.0)
    t = time.perf_counter()
    cm = cached_curried_model(unit.einsum, unit.arch, unit.skeleton)
    t_curry = time.perf_counter() - t
    t = time.perf_counter()
    obj = beam_objective(cm, unit.objective)
    return (unit.index, obj, t_curry, time.perf_counter() - t)


def _trace_unit(tracer: Tracer, unit: WorkUnit, t0: float,
                stats: MapperStats, candidate: Optional[MappingResult],
                step_buf: Tracer, truncated: bool = False) -> None:
    """Record one finished work unit on ``tracer``.

    Step samples are adopted only when the unit produced a mapping: units
    whose exploration yields no complete mapping do not contribute to
    ``MapperStats`` (historical contract, see :func:`run_work_unit`), and
    the trace keeps the same accounting so the summed per-step prune
    attribution equals the merged ``n_pruned_*`` counters exactly.  The
    unit span still records such units (``no_mapping`` + how many step
    samples were dropped), so dead skeletons stay visible in the profile.
    """
    args: Dict[str, Any] = {
        "index": unit.index,
        "einsum": getattr(unit.einsum, "name", None)
        or unit.einsum.__class__.__name__,
        "n_expanded": stats.n_expanded,
        "pruned_dominated": stats.n_pruned_dominated,
        "pruned_bound": stats.n_pruned_bound,
        "pruned_invalid": stats.n_pruned_invalid,
    }
    if truncated:
        args["truncated"] = True
    if candidate is None:
        args["no_mapping"] = True
        args["steps_dropped"] = len(step_buf.events)
    else:
        args["objective"] = candidate.objective(unit.objective)
        args["energy"] = candidate.energy
        args["latency"] = candidate.latency
        args["edp"] = candidate.edp
        tracer.extend(step_buf.events)
    tracer.complete(f"unit[{unit.index}]", t0, cat="unit", **args)


def run_work_unit(unit: WorkUnit,
                  inc_obj: float = float("inf"),
                  inc_reader: Optional[Callable[[], float]] = None,
                  tracer: Optional[Tracer] = None,
                  budget=None,
                  ) -> WorkResult:
    """Curry the model, explore tile shapes, return the unit's optimum.

    ``inc_obj``/``inc_reader`` pass an external incumbent bound through to
    :func:`~repro.core.tileshape.explore` (the two-phase engines' phase-2
    pruning); with the defaults this is exactly the historical
    per-unit-incumbent search.  Module-level (picklable) so it works under
    every multiprocessing start method.  Mirrors the historical driver loop
    exactly: stats of skeletons whose exploration yields no mapping are not
    accumulated.

    ``tracer`` (an *enabled* tracer or ``None``) records a per-unit span
    plus the unit's sampled step events; tracing is observational only, so
    results and stats are bit-identical either way.

    ``budget`` (a live meter from ``repro.core.budget``, or ``None``) makes
    the exploration anytime: an expired meter truncates the unit, which
    then reports its best-so-far mapping plus a sound completion lower
    bound (``WorkResult.truncated``/``lower_bound``).
    """
    _fault_hook(unit.index)
    t_wall = time.time() if tracer is not None else 0.0
    stats = MapperStats()
    t = time.perf_counter()
    cm = cached_curried_model(unit.einsum, unit.arch, unit.skeleton)
    stats.t_curry = time.perf_counter() - t

    # step samples land in a private buffer so no-result units can drop
    # them (see _trace_unit) without rewinding the master tracer
    step_buf = Tracer() if tracer is not None else None
    t = time.perf_counter()
    res = explore(cm, objective=unit.objective,
                  prune_partial=unit.prune_partial,
                  inc_obj=inc_obj, inc_reader=inc_reader, tracer=step_buf,
                  budget=budget)
    stats.t_tileshape = time.perf_counter() - t
    if res is None:
        if tracer is not None:
            _trace_unit(tracer, unit, t_wall, stats, None, step_buf)
        return WorkResult(unit.index, None, stats)
    stats.n_final_evals = res.stats.n_final
    stats.n_expanded = res.stats.n_expanded
    stats.n_pruned_dominated = res.stats.n_pruned_dominated
    stats.n_pruned_invalid = res.stats.n_pruned_invalid
    stats.n_pruned_bound = res.stats.n_pruned_bound
    if res.truncated:
        stats.truncated = True
        stats.n_truncated_units = 1
    candidate = (None if res.bounds is None else
                 MappingResult(cm.concretize(res.bounds),
                               res.energy, res.latency, res.edp))
    if tracer is not None:
        _trace_unit(tracer, unit, t_wall, stats, candidate, step_buf,
                    truncated=res.truncated)
    return WorkResult(unit.index, candidate, stats,
                      truncated=res.truncated, lower_bound=res.lower_bound)


def run_work_unit_traced(unit: WorkUnit,
                         inc_obj: float = float("inf")) -> WorkResult:
    """Pool task: run one unit with a fresh worker-side trace buffer.

    Workers cannot append to the driver's tracer, so each traced unit
    records into its own :class:`~repro.obs.tracer.Tracer` and ships the
    events back inside the picklable :class:`WorkResult`; the engine merges
    buffers in unit order.  Module-level so ``executor.map`` can pickle it.
    """
    tr = Tracer()
    r = run_work_unit(unit, inc_obj=inc_obj, tracer=tr)
    r.events = tr.events
    return r


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------


class SearchEngine:
    """Executes a batch of work units; results must come back in unit order.

    Engines implement the *two-phase global branch-and-bound*
    (``share_incumbents=True``): phase 1 beam-dives every unit to seed one
    global incumbent objective, phase 2 runs the full explorations against
    it, with every finished unit tightening the bound for the units still to
    come.  Sharing only ever *adds* prune power on top of each unit's own
    dive, and only cuts candidates provably no better than a real mapping,
    so the merged optimum's (energy, latency, edp) values are identical with
    sharing on or off, serial or parallel.
    """

    backend = "abstract"
    share_incumbents = True
    checkpoint = None  # optional journal.SearchCheckpoint

    def run(self, units: Sequence[WorkUnit],
            inc_obj: float = float("inf"),
            tracer=None, budget=None) -> List[WorkResult]:
        """Execute ``units``; ``inc_obj`` optionally seeds the incumbent
        with an externally known objective bound (e.g. a fusion group's
        independent-mapping sum — candidates provably no better than the
        fallback need not be explored).  With the default ``inf`` this is
        exactly the historical search.

        ``tracer`` (any tracer or ``None``) records phase spans (seed /
        search), per-unit spans with prune attribution, and incumbent
        tightenings; worker-side buffers are merged in unit order so the
        event stream layout is deterministic.  Tracing never changes
        results.

        ``budget`` (a ``SearchBudget`` spec or a live meter, or ``None``)
        makes the batch anytime: expired units come back truncated with
        sound completion lower bounds.  With a ``checkpoint`` journal
        attached, finished results are appended as they complete and
        journaled units are served without re-searching."""
        raise NotImplementedError

    def close(self) -> None:
        """Release executor resources (worker pools) and drop the search
        memos (:func:`clear_search_caches`), so batch drivers that open and
        close engines per model do not accumulate curried models across a
        long sweep.  Idempotent — safe to call again after a failure."""
        clear_search_caches()

    def __enter__(self) -> "SearchEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    @staticmethod
    def _sharing_applies(units: Sequence[WorkUnit]) -> bool:
        # pruning off => no incumbents at all; a single unit has nothing to
        # share with (its own dive already seeds its local incumbent)
        return len(units) > 1 and all(u.prune_partial for u in units)


class SerialEngine(SearchEngine):
    """In-process, in-order execution — deterministic reference backend.

    With ``share_incumbents`` the incumbent tightening is sequential in unit
    order, so runs are exactly reproducible (no scheduling races).
    """

    backend = "serial"

    def __init__(self, share_incumbents: bool = True, checkpoint=None):
        self.share_incumbents = share_incumbents
        self.checkpoint = checkpoint

    def _resume(self, units: Sequence[WorkUnit],
                tracer) -> Dict[int, WorkResult]:
        """Journal lookups for the whole batch (empty without a journal)."""
        done: Dict[int, WorkResult] = {}
        if self.checkpoint is None:
            return done
        for u in units:
            r = self.checkpoint.get(u)
            if r is not None:
                done[u.index] = r
                if tracer is not None:
                    tracer.instant("resume_hit", cat="checkpoint",
                                   unit=u.index)
        return done

    def run(self, units: Sequence[WorkUnit],
            inc_obj: float = float("inf"),
            tracer=None, budget=None) -> List[WorkResult]:
        tracer = active(tracer)
        meter = ensure_meter(budget)
        ckpt = self.checkpoint
        done = self._resume(units, tracer)
        if not (self.share_incumbents and self._sharing_applies(units)):
            with (tracer.span("search", cat="phase", n_units=len(units),
                              backend=self.backend)
                  if tracer is not None else nullcontext()):
                results = []
                for u in units:
                    r = done.get(u.index)
                    if r is None:
                        r = run_work_unit(u, inc_obj=inc_obj, tracer=tracer,
                                          budget=meter)
                        if ckpt is not None:
                            ckpt.put(u, r)
                    results.append(r)
                return results
        inc = inc_obj
        # journaled optima are real mappings — sound incumbent seeds
        for r in done.values():
            if r.candidate is not None:
                inc = min(inc, r.candidate.objective(units[0].objective))
        t_seed: Dict[int, Tuple[float, float]] = {}
        with (tracer.span("seed", cat="phase", n_units=len(units),
                          backend=self.backend)
              if tracer is not None else nullcontext()):
            for u in units:
                if u.index in done:
                    continue
                if meter is not None and meter.expired():
                    break  # unseeded units just prune less — still sound
                i, obj, t_curry, t_dive = run_seed_unit(u)
                t_seed[i] = (t_curry, t_dive)
                inc = min(inc, obj)
        if tracer is not None and inc != float("inf"):
            tracer.instant("seeded", cat="incumbent", objective=inc,
                           source="beam-dive")
        results = []
        with (tracer.span("search", cat="phase", n_units=len(units),
                          backend=self.backend)
              if tracer is not None else nullcontext()):
            for u in units:
                r = done.get(u.index)
                if r is not None:
                    results.append(r)
                    continue
                r = run_work_unit(u, inc_obj=inc, tracer=tracer,
                                  budget=meter)
                t_curry, t_dive = t_seed.get(u.index, (0.0, 0.0))
                r.stats.t_curry += t_curry
                r.stats.t_tileshape += t_dive
                if ckpt is not None:
                    ckpt.put(u, r)
                if r.candidate is not None:
                    obj = r.candidate.objective(u.objective)
                    if obj < inc:
                        inc = obj
                        if tracer is not None:
                            tracer.instant("tighten", cat="incumbent",
                                           objective=obj,
                                           source=f"unit[{u.index}]")
                results.append(r)
        return results


# Per-worker handle on the engine's shared incumbent (a multiprocessing
# ``Value('d')``), installed by the pool initializer.  Reads go straight at
# ``.value`` without taking the lock: a stale read is harmless (the bound
# only ever tightens, so pruning stays sound), and the load is assumed
# atomic — true for an aligned 8-byte double on every 64-bit platform this
# repo targets; a 32-bit host where such loads can tear should read under
# ``get_lock()`` instead.  Writes are CAS-style under the lock in
# ``_tighten_shared``.
_WORKER_INCUMBENT = None

# Worker handle on the pool's shared budget slots: (deadline epoch 'd',
# remaining-node cap 'q', consumed-node counter 'q') Values, or None.  A
# deadline of inf with a negative cap means "no budget active this batch" —
# _worker_meter() then returns None and every task runs its historical path.
_WORKER_BUDGET = None


def _init_worker(shared, budget_values=None,
                 fault_plan: Optional[str] = None) -> None:
    global _WORKER_INCUMBENT, _WORKER_BUDGET
    _WORKER_INCUMBENT = shared
    _WORKER_BUDGET = budget_values
    if fault_plan is not None:
        _set_fault_plan(fault_plan)


def _worker_meter() -> Optional[SharedBudgetMeter]:
    bv = _WORKER_BUDGET
    if bv is None:
        return None
    if bv[0].value == float("inf") and bv[1].value < 0:
        return None
    return SharedBudgetMeter(*bv)


def _tighten_shared(shared, obj: float) -> bool:
    """Monotonically tighten the shared bound (compare-and-set under lock).

    Returns whether ``obj`` actually improved the published bound, so
    traced workers emit incumbent instants only for real tightenings.
    """
    with shared.get_lock():
        if obj < shared.value:
            shared.value = obj
            return True
    return False


def _read_shared() -> float:
    return _WORKER_INCUMBENT.value


def run_work_unit_shared(unit: WorkUnit, trace: bool = False) -> WorkResult:
    """Phase-2 worker task: explore against the shared global incumbent.

    The initial bound and the per-B&B-step re-reads come from the shared
    ``Value``; a finished unit with a complete mapping publishes its
    objective so in-flight and queued units prune against it.  With
    ``trace`` the unit records into a fresh worker-side buffer shipped back
    in ``WorkResult.events`` (see :func:`run_work_unit_traced`).
    """
    tr = Tracer() if trace else None
    shared = _WORKER_INCUMBENT
    budget = _worker_meter()
    if shared is None:  # engine without sharing: plain unit
        r = run_work_unit(unit, tracer=tr, budget=budget)
    else:
        r = run_work_unit(unit, inc_obj=shared.value,
                          inc_reader=_read_shared, tracer=tr, budget=budget)
        if r.candidate is not None:
            obj = r.candidate.objective(unit.objective)
            if _tighten_shared(shared, obj) and tr is not None:
                tr.instant("tighten", cat="incumbent", objective=obj,
                           source=f"unit[{unit.index}]")
    if tr is not None:
        r.events = tr.events
    return r


def run_work_unit_pooled(unit: WorkUnit, inc_obj: float = float("inf"),
                         trace: bool = False) -> WorkResult:
    """Pool task for *budgeted, unshared* runs: like
    :func:`run_work_unit`/:func:`run_work_unit_traced` but drawing down the
    pool's shared budget slots.  Kept separate so unbudgeted runs keep
    dispatching the historical task functions (bit-parity contract)."""
    tr = Tracer() if trace else None
    r = run_work_unit(unit, inc_obj=inc_obj, tracer=tr,
                      budget=_worker_meter())
    if tr is not None:
        r.events = tr.events
    return r


def run_seed_unit_pooled(unit: WorkUnit) -> Tuple[int, float, float, float]:
    """Budget-aware phase-1 task: skip the dive once the budget expired
    (seeding is an optimization — a missing seed only weakens pruning)."""
    m = _worker_meter()
    if m is not None and m.expired():
        return (unit.index, float("inf"), 0.0, 0.0)
    return run_seed_unit(unit)


def _run_chunk(fn, chunk: Sequence[WorkUnit]) -> List[Tuple[str, Any]]:
    """Fault-isolating pool task: run ``fn`` over a chunk of units,
    capturing per-unit Python-level exceptions as ``("err", message)``
    markers so one deterministic failure cannot discard its chunk-mates'
    results.  (Process death still loses the in-flight chunk — the engine
    retries those units on a fresh pool.)"""
    out: List[Tuple[str, Any]] = []
    for u in chunk:
        try:
            out.append(("ok", fn(u)))
        except Exception as e:  # noqa: BLE001 — marker, retried/quarantined
            out.append(("err", f"{type(e).__name__}: {e}"))
    return out


def _merge_worker_events(tracer: Optional[Tracer],
                         results: Sequence[WorkResult]) -> None:
    """Fold worker-side event buffers into the driver tracer.

    ``results`` follows the units sequence (``executor.map`` preserves
    ordering), so the merged stream layout is deterministic regardless of
    which worker ran which unit or when; chronology is recovered at export
    time from the wall-clock timestamps.  Buffers are detached after the
    merge so results do not carry duplicate event payloads downstream.
    """
    if tracer is None:
        return
    for r in results:
        tracer.extend(r.events)
        r.events = None


def _default_start_method() -> str:
    """Prefer a start method that does not fork the calling process.

    Callers (benchmarks, examples) routinely import JAX, which is
    multithreaded — plain ``fork`` of such a process can deadlock.  Both
    ``forkserver`` (Linux: workers fork from a clean server process) and
    ``spawn`` (everywhere) avoid inheriting the parent's threads; the worker
    entry point ``run_work_unit`` is module-level, so both can pickle it.
    """
    methods = mp.get_all_start_methods()
    return "forkserver" if "forkserver" in methods else "spawn"


class ProcessPoolEngine(SearchEngine):
    """Process-pool execution with a configurable worker count.

    Results are reassembled in unit order regardless of completion order,
    so merging downstream is order-identical to the serial backend.  Falls
    back to serial execution when there is nothing to parallelize.

    **Fault tolerance**: a dead worker no longer poisons the batch.  Units
    lost to a ``BrokenExecutor`` are retried on a fresh pool (bounded by
    ``max_retries``, exponential backoff, one unit per chunk after the
    first death so a poison unit cannot keep taking hostages); the shared
    incumbent and budget draw-down survive pool replacement.  Units that
    keep killing workers fall back to in-process execution
    (``serial_fallback``) and, failing that too, are quarantined as
    replayable JSON repros under ``quarantine_dir`` (default
    ``.tcm_cache/quarantine/``) with a placeholder result whose zero lower
    bound keeps the driver's gap certificate honest.  Completed
    ``WorkResult``s are never lost; see ``fault_stats`` and the
    ``n_retried_units``/``n_quarantined_units`` stats counters.

    The pool is created lazily on first use and **persists across ``run``
    calls**, so batch drivers that search many einsums through one engine
    (``repro.netmap``) pay the worker start-up cost once.  Call
    :meth:`close` when done — a dropped engine's workers are only reaped at
    interpreter exit (``ProcessPoolExecutor`` has no ``__del__``).
    """

    backend = "process"

    def __init__(self, workers: Optional[int] = None,
                 chunksize: Optional[int] = None,
                 start_method: Optional[str] = None,
                 share_incumbents: bool = True,
                 checkpoint=None,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 serial_fallback: bool = True,
                 quarantine_dir: Optional[str] = None):
        self.workers = int(workers) if workers else (os.cpu_count() or 1)
        self.chunksize = chunksize
        self.start_method = start_method or _default_start_method()
        self.share_incumbents = share_incumbents
        self.checkpoint = checkpoint
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.serial_fallback = bool(serial_fallback)
        self.quarantine_dir = quarantine_dir
        # fault accounting for the whole engine lifetime (also folded into
        # the affected units' MapperStats, so drivers see it in merges)
        self.fault_stats = {"retries": 0, "pool_restarts": 0,
                            "serial_fallbacks": 0, "quarantined": 0}
        self._executor: Optional[ProcessPoolExecutor] = None
        self._shared = None  # mp.Value('d'): the published global incumbent
        self._budget_values = None  # (deadline 'd', cap 'q', nodes 'q')
        # One engine may be shared by many service threads.  A run owns the
        # pool's shared incumbent/budget slots for its whole batch, so
        # concurrent run() calls must serialize (they would otherwise
        # re-arm each other's budget slots mid-batch); close() must be
        # idempotent under concurrent callers (request threads and the
        # service shutdown path can race).
        self._run_lock = threading.Lock()
        self._lifecycle_lock = threading.Lock()
        self._closed = False

    def _get_executor(self) -> ProcessPoolExecutor:
        if self._executor is None:
            ctx = mp.get_context(self.start_method)
            # one shared slot for the pool's lifetime; run() re-seeds it per
            # batch.  ``Value`` handles are picklable as initargs, so this
            # works under fork, forkserver and spawn alike.  The budget
            # slots start inactive (inf deadline, negative cap); run()
            # arms them only when a budget is passed.
            self._shared = ctx.Value("d", float("inf"))
            self._budget_values = (ctx.Value("d", float("inf")),
                                   ctx.Value("q", -1), ctx.Value("q", 0))
            self._executor = ProcessPoolExecutor(
                max_workers=self.workers, mp_context=ctx,
                initializer=_init_worker,
                initargs=(self._shared if self.share_incumbents else None,
                          self._budget_values,
                          os.environ.get("TCM_FAULT_PLAN")))
        return self._executor

    def _recycle_pool(self, tracer=None, lost: int = 0) -> None:
        """Replace a broken pool, preserving the published incumbent and
        the budget draw-down — retried units must keep pruning against the
        best mapping found before the worker died."""
        prev_inc = (self._shared.value if self._shared is not None
                    else float("inf"))
        prev_budget = None
        if self._budget_values is not None:
            d, c, n = self._budget_values
            prev_budget = (d.value, c.value, n.value)
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
        self._executor = None
        self._shared = None
        self._budget_values = None
        self._get_executor()
        self._shared.value = prev_inc
        if prev_budget is not None:
            d, c, n = self._budget_values
            d.value, c.value, n.value = prev_budget
        self.fault_stats["pool_restarts"] += 1
        if tracer is not None:
            tracer.instant("pool_restart", cat="fault", lost_units=lost)

    def _arm_budget(self, meter) -> None:
        """Mirror the driver meter into the pool's shared slots for one
        batch (or disarm them when no budget is active)."""
        if self._budget_values is None:
            return
        d, c, n = self._budget_values
        with n.get_lock():
            n.value = 0
        if meter is None:
            d.value = float("inf")
            c.value = -1
        else:
            epoch = meter.deadline_epoch
            d.value = float("inf") if epoch is None else float(epoch)
            rem = meter.remaining_nodes()
            c.value = -1 if rem is None else int(rem)

    def _settle_budget(self, meter) -> None:
        """Fold the workers' consumed-node count back into the driver
        meter after a batch, so one budget spans many engine runs."""
        if meter is not None and self._budget_values is not None:
            meter.charge(int(self._budget_values[2].value))

    def _quarantine_root(self) -> str:
        return self.quarantine_dir or os.path.join(".tcm_cache",
                                                   "quarantine")

    def _robust_map(self, fn, items: Sequence[WorkUnit], chunksize: int,
                    tracer, on_give_up, serial_fn=None, on_result=None,
                    ) -> Tuple[List[Any], Dict[int, int]]:
        """Chunked fan-out with bounded retry on worker death.

        Returns ``(outputs in items order, retry-attempt counts by unit
        index)``.  A chunk lost to a dead worker is retried on a fresh pool
        — one unit per chunk from then on, so a poison unit cannot keep
        taking hostages — up to ``max_retries`` times per unit with
        exponential backoff.  Units that exhaust their retries (and units
        whose task raised a deterministic Python exception, which retrying
        cannot fix) go to ``serial_fn`` (in-process fallback) when enabled,
        else to ``on_give_up``.  ``on_result`` fires as each unit's output
        arrives — before the batch completes — so checkpoints journal
        results a later interrupt cannot lose.
        """
        out: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        attempts: Dict[int, int] = {}
        pending = list(items)
        csize = chunksize
        while pending:
            executor = self._get_executor()
            chunks = [pending[i:i + csize]
                      for i in range(0, len(pending), csize)]
            futs = {executor.submit(_run_chunk, fn, ch): ch for ch in chunks}
            lost: List[WorkUnit] = []
            broke = False
            for fut in as_completed(futs):
                ch = futs[fut]
                try:
                    rets = fut.result()
                except BrokenExecutor:
                    lost.extend(ch)
                    broke = True
                    continue
                for u, (tag, val) in zip(ch, rets):
                    if tag == "ok":
                        out[u.index] = val
                        if on_result is not None:
                            on_result(u, val)
                    else:
                        errors[u.index] = val
            pending = []
            for u in lost:
                attempts[u.index] = attempts.get(u.index, 0) + 1
                if attempts[u.index] <= self.max_retries:
                    pending.append(u)
                else:
                    errors.setdefault(u.index,
                                      "worker process died repeatedly")
            if broke:
                restarts = self.fault_stats["pool_restarts"]
                time.sleep(self.retry_backoff_s * min(8, 2 ** restarts))
                self._recycle_pool(tracer, lost=len(lost))
                csize = 1  # isolate: retried units run one per chunk
            if pending:
                self.fault_stats["retries"] += len(pending)
                if tracer is not None:
                    tracer.instant("retry", cat="fault",
                                   n_units=len(pending))
        for u in items:
            if u.index in out:
                continue
            err = errors.get(u.index, "unknown failure")
            val = None
            if serial_fn is not None and self.serial_fallback:
                try:
                    val = serial_fn(u)
                    self.fault_stats["serial_fallbacks"] += 1
                    if tracer is not None:
                        tracer.instant("serial_fallback", cat="fault",
                                       unit=u.index)
                except Exception as e:  # noqa: BLE001 — quarantine below
                    err = f"{type(e).__name__}: {e}"
            if val is None:
                val = on_give_up(u, err, attempts.get(u.index, 0))
            out[u.index] = val
            if on_result is not None:
                on_result(u, val)
        return [out[u.index] for u in items], attempts

    def _give_up_result(self, tracer):
        """Build the quarantine handler for a search phase: write a
        replayable repro, return a placeholder WorkResult whose zero lower
        bound makes the driver's gap certificate honestly infinite."""
        def _quarantine(u: WorkUnit, err: str, attempts: int) -> WorkResult:
            from .journal import write_unit_repro
            path = None
            try:
                path = write_unit_repro(u, err, attempts,
                                        self._quarantine_root())
            except Exception:  # noqa: BLE001 — quarantine is best-effort
                pass
            self.fault_stats["quarantined"] += 1
            if tracer is not None:
                tracer.instant("quarantine", cat="fault", unit=u.index,
                               error=err, repro=path)
            st = MapperStats()
            st.truncated = True
            st.n_quarantined_units = 1
            st.n_retried_units = attempts
            return WorkResult(u.index, None, st,
                              truncated=True, lower_bound=0.0)
        return _quarantine

    def run(self, units: Sequence[WorkUnit],
            inc_obj: float = float("inf"),
            tracer=None, budget=None) -> List[WorkResult]:
        if self._closed:
            raise RuntimeError(
                "ProcessPoolEngine.run() called after close(); build a "
                "fresh engine (make_engine) instead of reusing a closed one")
        tracer = active(tracer)
        meter = ensure_meter(budget)
        if self.workers <= 1 or len(units) <= 1:
            return SerialEngine(
                self.share_incumbents, checkpoint=self.checkpoint,
            ).run(units, inc_obj, tracer=tracer, budget=meter)
        # Serialize whole batches: the pool's shared incumbent and budget
        # slots are per-batch state, so two interleaved run() calls would
        # silently prune each other against the wrong incumbent/deadline.
        with self._run_lock:
            if self._closed:
                raise RuntimeError(
                    "ProcessPoolEngine closed while a run was queued")
            return self._run_locked(units, inc_obj, tracer, meter)

    def _run_locked(self, units: Sequence[WorkUnit], inc_obj: float,
                    tracer, meter) -> List[WorkResult]:
        # Unit costs are heavily skewed (one skeleton can dominate the whole
        # search), so default to dynamic scheduling (chunksize 1); batching
        # only pays off once there are very many units per worker.
        chunksize = self.chunksize or max(1, len(units) // (self.workers * 64))
        results: Dict[int, WorkResult] = {}
        todo: List[WorkUnit] = []
        if self.checkpoint is not None:
            for u in units:
                r = self.checkpoint.get(u)
                if r is not None:
                    results[u.index] = r
                    if tracer is not None:
                        tracer.instant("resume_hit", cat="checkpoint",
                                       unit=u.index)
                else:
                    todo.append(u)
        else:
            todo = list(units)
        ckpt = self.checkpoint
        on_result = ((lambda u, r: ckpt.put(u, r))
                     if ckpt is not None else None)
        try:
            if todo:
                self._get_executor()
                self._arm_budget(meter)
                try:
                    if not (self.share_incumbents
                            and self._sharing_applies(units)):
                        self._run_unshared(todo, units, inc_obj, chunksize,
                                           tracer, meter, results, on_result)
                    else:
                        self._run_shared(todo, units, inc_obj, chunksize,
                                         tracer, meter, results, on_result)
                finally:
                    self._settle_budget(meter)
        except KeyboardInterrupt:
            # best-so-far semantics: completed units are already journaled
            # (on_result fires per completion); drop the broken pool so a
            # retried run starts clean, then let the driver report
            self._abort_pool()
            raise
        return [results[u.index] for u in units]

    def _run_unshared(self, todo, units, inc_obj, chunksize, tracer, meter,
                      results, on_result) -> None:
        if meter is not None:
            fn: Callable = functools.partial(run_work_unit_pooled,
                                             inc_obj=inc_obj,
                                             trace=tracer is not None)
        elif tracer is not None:
            fn = functools.partial(run_work_unit_traced, inc_obj=inc_obj)
        elif inc_obj != float("inf"):
            fn = functools.partial(run_work_unit, inc_obj=inc_obj)
        else:
            fn = run_work_unit
        serial_fn = functools.partial(run_work_unit, inc_obj=inc_obj,
                                      budget=meter)
        with (tracer.span("search", cat="phase", n_units=len(units),
                          backend=self.backend, workers=self.workers)
              if tracer is not None else nullcontext()):
            out, attempts = self._robust_map(
                fn, todo, chunksize, tracer,
                on_give_up=self._give_up_result(tracer),
                serial_fn=serial_fn, on_result=on_result)
        for u, r in zip(todo, out):
            if attempts.get(u.index):
                r.stats.n_retried_units = max(r.stats.n_retried_units,
                                              attempts[u.index])
            results[u.index] = r
        _merge_worker_events(tracer, out)

    def _run_shared(self, todo, units, inc_obj, chunksize, tracer, meter,
                    results, on_result) -> None:
        # phase 1: beam-dive every unit, seed the shared incumbent.
        # Memoization is per-process, so a phase-2 unit landing on a
        # different worker re-curries and re-dives — the pool trades
        # aggregate CPU seconds for wall time here.
        seed_fn = run_seed_unit_pooled if meter is not None else run_seed_unit
        with (tracer.span("seed", cat="phase", n_units=len(units),
                          backend=self.backend, workers=self.workers)
              if tracer is not None else nullcontext()):
            seeds, _ = self._robust_map(
                seed_fn, todo, chunksize, tracer,
                on_give_up=lambda u, err, att: (u.index, float("inf"),
                                                0.0, 0.0))
        seed_obj = min((s[1] for s in seeds), default=inc_obj)
        # checkpointed optima are real mappings — sound incumbent seeds
        objective = units[0].objective
        for r in results.values():
            if r.candidate is not None:
                seed_obj = min(seed_obj, r.candidate.objective(objective))
        with self._shared.get_lock():
            self._shared.value = min(seed_obj, inc_obj)
        if tracer is not None and self._shared.value != float("inf"):
            tracer.instant("seeded", cat="incumbent",
                           objective=self._shared.value,
                           source="beam-dive")
        # phase 2: full explorations against the improving global bound
        fn = (functools.partial(run_work_unit_shared, trace=True)
              if tracer is not None else run_work_unit_shared)

        def serial_fn(u: WorkUnit) -> WorkResult:
            # in-process fallback still prunes against (and tightens) the
            # published global incumbent
            r = run_work_unit(u, inc_obj=self._shared.value, budget=meter)
            if r.candidate is not None:
                _tighten_shared(self._shared,
                                r.candidate.objective(u.objective))
            return r

        with (tracer.span("search", cat="phase", n_units=len(units),
                          backend=self.backend, workers=self.workers)
              if tracer is not None else nullcontext()):
            out, attempts = self._robust_map(
                fn, todo, chunksize, tracer,
                on_give_up=self._give_up_result(tracer),
                serial_fn=serial_fn, on_result=on_result)
        # seeds/out both follow the todo sequence order
        for r, (_, _, t_curry, t_dive) in zip(out, seeds):
            r.stats.t_curry += t_curry
            r.stats.t_tileshape += t_dive
        for u, r in zip(todo, out):
            if attempts.get(u.index):
                r.stats.n_retried_units = max(r.stats.n_retried_units,
                                              attempts[u.index])
            results[u.index] = r
        _merge_worker_events(tracer, out)

    def _abort_pool(self) -> None:
        """Tear down the executor without waiting (interrupt path); the
        engine stays usable — the next run() builds a fresh pool."""
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
        self._executor = None
        self._shared = None
        self._budget_values = None

    def close(self) -> None:
        """Idempotent and safe under concurrent callers: exactly one
        caller shuts the executor down; the rest (and repeat calls) are
        no-ops.  A run in flight finishes first — close() waits on the
        run lock rather than yanking the pool out from under it."""
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
        with self._run_lock:
            if self._executor is not None:
                self._executor.shutdown()
            self._executor = None
            self._shared = None
            self._budget_values = None
        clear_search_caches()


def make_engine(backend: Optional[str] = None,
                workers: Optional[int] = None,
                share_incumbents: bool = True,
                checkpoint=None) -> SearchEngine:
    """Resolve a backend name + worker count to an engine.

    ``backend=None`` auto-selects: the process pool iff ``workers`` asks for
    more than one worker, else the deterministic serial engine (the default
    used by the test suite and by ``tcm_map`` with no arguments).
    ``share_incumbents=False`` disables cross-unit bound propagation,
    reproducing the per-unit-incumbent search exactly.  ``checkpoint`` (a
    ``journal.SearchCheckpoint``, or None) journals finished results and
    serves them on resumed runs.  Engines are context managers:
    ``with make_engine(...) as eng: ...`` closes on exit.
    """
    if backend is None:
        backend = "process" if workers and workers > 1 else "serial"
    if backend == "serial":
        return SerialEngine(share_incumbents=share_incumbents,
                            checkpoint=checkpoint)
    if backend == "process":
        return ProcessPoolEngine(workers=workers,
                                 share_incumbents=share_incumbents,
                                 checkpoint=checkpoint)
    raise ValueError(f"unknown search backend {backend!r}")
