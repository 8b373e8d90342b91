"""The Turbo-Charged Mapper driver (paper §V, Fig. 5).

Pipeline: enumerate dataplacements -> per dataplacement, enumerate
Pareto-relevant dataflow skeletons -> materialize one work unit per
(dataplacement, skeleton) -> dispatch the units through a search engine
(``search.SerialEngine`` by default; ``search.ProcessPoolEngine`` for
parallel runs) -> each unit curries the model once and explores tile shapes
with partial-tile-shape pruning -> merge per-unit stats and reduce to the
global optimum.  Also accounts mapspace sizes (total vs non-pruned;
Table II / Figs. 6-7) and phase runtimes (Fig. 8).

The reduction is order-identical across backends: units are merged in
enumeration order with a strict ``<`` comparison, so the parallel backend
returns bit-identical optima and stats to the serial one.
"""
from __future__ import annotations

import math
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.tracer import active
from .arch import Arch
from .budget import ensure_meter
from .dataflow import count_unpruned_dataflows, make_slots
from .einsum import Einsum
from .factor import prime_factorization as _prime_factorization
from .fusion import (FusedWorkload, enumerate_fused_skeletons, validate_fused)
from .looptree import Loop, Mapping, validate_structure
from .search import (MapperStats, MappingResult, SearchEngine, WorkUnit,
                     cached_dataplacements, cached_skeletons, make_engine)


def count_ordered_factorizations(n: int, slots: int) -> float:
    """Number of ways to write n as an ordered product of `slots` factors."""
    if slots <= 0:
        return 1.0 if n == 1 else 0.0
    total = 1.0
    for _, e in _prime_factorization(n):
        total *= math.comb(e + slots - 1, slots - 1)
    return total


def _log10_tileshapes(einsum: Einsum, positions_per_var: Dict[str, int]) -> float:
    out = 0.0
    for v, shape in einsum.rank_shapes.items():
        c = count_ordered_factorizations(shape, positions_per_var.get(v, 1))
        out += math.log10(max(c, 1.0))
    return out


def unpruned_mapspace_log10(einsum: Einsum, arch: Arch) -> float:
    """log10 |Mapspace| = |DP| * |DF| * |TS| without any pruning."""
    total = 0.0
    n_dp = 0
    for dp in cached_dataplacements(einsum, arch):
        n_dp += 1
        slots = make_slots(einsum, arch, dp)
        n_slots = len(slots)
        n_spatial = sum(len(f.dims) for f in arch.fanouts)
        df = count_unpruned_dataflows(einsum, arch, dp)
        ts = _log10_tileshapes(
            einsum, {v: n_slots + n_spatial for v in einsum.rank_shapes})
        total += 10 ** min(math.log10(max(df, 1.0)) + ts, 300)
    return math.log10(max(total, 1.0))


def build_work_units(
    einsum: Einsum,
    arch: Arch,
    objective: str,
    prune_partial: bool,
    collect_sizes: bool,
    stats: MapperStats,
    index_base: int = 0,
) -> List[WorkUnit]:
    """Materialize the dataplacement x skeleton cross-product.

    Fills the driver-side fields of ``stats`` (dataplacement/dataflow counts,
    enumeration timings and mapspace-size accumulators) as a side effect, in
    the exact enumeration order the serial driver has always used.
    ``index_base`` offsets the unit indices so batches for several
    architecture points can be concatenated into one engine dispatch
    (:func:`tcm_map_best_arch`) without index collisions.
    """
    t = time.perf_counter()
    dps = cached_dataplacements(einsum, arch)
    stats.n_dataplacements = len(dps)
    stats.t_dataplacement = time.perf_counter() - t

    units: List[WorkUnit] = []
    for dp in dps:
        t = time.perf_counter()
        skeletons = cached_skeletons(einsum, arch, dp)
        stats.t_dataflow += time.perf_counter() - t
        stats.n_skeletons += len(skeletons)

        if collect_sizes:
            slots = make_slots(einsum, arch, dp)
            n_slots = len(slots)
            n_spatial = sum(len(f.dims) for f in arch.fanouts)
            df_unpruned = count_unpruned_dataflows(einsum, arch, dp)
            ts_unpruned = _log10_tileshapes(
                einsum, {v: n_slots + n_spatial for v in einsum.rank_shapes})
            stats.sum_total += 10 ** min(
                math.log10(max(df_unpruned, 1.0)) + ts_unpruned - 300, 0)
            # dataflow pruning only: pruned DF count, unpruned tile shapes
            stats.sum_df_pruned += len(skeletons) * 10 ** min(
                ts_unpruned - 300, 0)

        for sk in skeletons:
            if collect_sizes:
                ppv: Dict[str, int] = {}
                for n in sk:
                    if isinstance(n, Loop):
                        ppv[n.var] = ppv.get(n.var, 0) + 1
                stats.sum_loop_pruned += 10 ** min(
                    _log10_tileshapes(einsum, ppv) - 300, 0)
            units.append(WorkUnit(index_base + len(units), einsum, arch, sk,
                                  objective, prune_partial))
    return units


def tcm_map(
    einsum: Einsum,
    arch: Arch,
    objective: str = "edp",
    prune_partial: bool = True,
    collect_sizes: bool = True,
    verbose: bool = False,
    engine: Optional[SearchEngine] = None,
    backend: Optional[str] = None,
    workers: Optional[int] = None,
    share_incumbents: bool = True,
    inc_obj: float = float("inf"),
    tracer=None,
    budget=None,
    checkpoint=None,
) -> Tuple[Optional[MappingResult], MapperStats]:
    """Find the optimal mapping of ``einsum`` on ``arch``.

    ``engine``/``backend``/``workers`` select the search executor: by default
    (all three unset) the deterministic serial engine runs everything in this
    process; ``workers=N`` (N > 1) or ``backend="process"`` fans the
    dataplacement x skeleton work units out over a process pool.  Both
    backends return value-identical optima.

    ``share_incumbents`` enables the two-phase global branch-and-bound: a
    cheap beam dive over every work unit first seeds a shared incumbent, and
    each finished unit tightens it, so later units prune against the best
    mapping found *anywhere* rather than only their own dive.  The pruning is
    sound (only provably-no-better candidates are cut), so the optimum's
    (energy, latency, edp) values are identical either way;
    ``share_incumbents=False`` reproduces the per-unit-incumbent search —
    and, on the serial backend, its exact per-unit statistics — of old.
    Ignored when a caller-provided ``engine`` is passed (the engine's own
    setting governs).

    ``inc_obj`` seeds the branch-and-bound with an *external* objective
    upper bound (``repro.dse`` passes the best architecture point found so
    far).  With the default ``inf`` the search is exactly historical.  The
    pruning is sound but one-sided: when the returned optimum's objective
    is strictly below ``inc_obj`` it is the true optimum; a ``None`` result
    (or one at/above the bound) only proves the true optimum is no better
    than ``inc_obj`` — callers that seed must fall back accordingly.

    ``tracer`` (a ``repro.obs`` tracer, or ``None``) records the full span
    hierarchy of this call — enumeration, seed/search phases, per-unit
    explorations with prune attribution, incumbent tightenings — without
    changing any result: with tracing off (the default) optima and stats
    are bit-identical to the untraced search.

    ``budget`` (a :class:`~repro.core.budget.SearchBudget`, a live meter, or
    ``None``) makes the search *anytime*: on deadline/node-cap expiry the
    best incumbent found so far is returned with ``stats.truncated=True``
    and a certified optimality bound in ``stats.gap_bound`` (the true
    optimum is provably within that factor; ``inf`` when nothing sound is
    known).  ``budget=None`` (the default) is bit-identical to the
    unbudgeted search, stats included.

    ``checkpoint`` (a :class:`~repro.core.journal.SearchCheckpoint`, or
    ``None``) journals every finished work unit and serves journaled units
    on a later identical call without re-searching — the resume path for
    interrupted runs.  Only honored when this call creates its own engine;
    a caller-provided ``engine`` keeps its own checkpoint setting.
    """
    tracer = active(tracer)
    stats = MapperStats()
    t0 = time.perf_counter()
    t_wall = time.time() if tracer is not None else 0.0

    with (tracer.span("enumerate", cat="phase", einsum=einsum.name)
          if tracer is not None else nullcontext()):
        units = build_work_units(einsum, arch, objective, prune_partial,
                                 collect_sizes, stats)
    meter = ensure_meter(budget)
    owns_engine = engine is None
    if owns_engine:
        engine = make_engine(backend, workers,
                             share_incumbents=share_incumbents,
                             checkpoint=checkpoint)
    if verbose:
        print(f"dispatching {len(units)} work units "
              f"({stats.n_dataplacements} dataplacements) "
              f"via {engine.backend}")

    best: Optional[MappingResult] = None
    try:
        best = _run_and_merge(units, objective, engine, stats,
                              inc_obj=inc_obj, tracer=tracer, budget=meter)
    finally:
        # engines passed in by the caller stay open (netmap reuses one pool
        # across a whole model's searches); self-made ones are torn down
        if owns_engine:
            engine.close()
    if best is not None:
        validate_structure(einsum, arch, best.mapping)
    if verbose:
        print(f"merged {len(units)} units: "
              f"best={best.edp if best else None}")

    stats.finalize()
    stats.t_total = time.perf_counter() - t0
    if tracer is not None:
        extra = ({"truncated": True, "gap_bound": stats.gap_bound}
                 if stats.truncated else {})
        tracer.complete(
            f"tcm_map:{einsum.name}", t_wall, cat="driver",
            backend=engine.backend, n_units=len(units),
            objective_kind=objective,
            objective=best.objective(objective) if best else None,
            n_expanded=stats.n_expanded, **extra)
    return best, stats


def _certify_gap(stats: MapperStats, best: Optional[MappingResult],
                 objective: str, inc_obj: float, frontier_lb: float) -> None:
    """Turn the surviving lower bounds of a truncated run into a certified
    optimality gap (``stats.gap_bound``).

    Soundness: every mapping the search did not fully evaluate was either
    (a) in a truncated unit's surviving frontier — objective >= that unit's
    relaxed ``lower_bound``; (b) bound-pruned — objective >= the bound at
    prune time >= the final bound ``min(best, inc_obj)`` (the bound only
    tightens); or (c) dominance/invalid-pruned, whose completions are
    covered by a surviving or bound-pruned candidate.  So the true optimum
    >= ``min(best, inc_obj, frontier_lb)`` and the returned incumbent is
    within ``best / that`` of it.  A non-positive or non-finite lower bound
    certifies nothing: the gap is ``inf`` (honest, not a failure).
    """
    if not stats.truncated:
        return
    best_obj = best.objective(objective) if best is not None else float("inf")
    lb = min(best_obj, inc_obj, frontier_lb)
    if best is None or lb <= 0.0 or not math.isfinite(lb):
        stats.gap_bound = float("inf")
    else:
        stats.gap_bound = max(stats.gap_bound, best_obj / lb)


def _run_and_merge(units, objective: str, engine: SearchEngine,
                   stats: MapperStats,
                   inc_obj: float = float("inf"),
                   tracer=None, budget=None) -> Optional[MappingResult]:
    """Dispatch units through ``engine`` and reduce in enumeration order.

    The strict ``<`` comparison in unit order is the bit-parity contract:
    both backends return results in unit order, so the selected optimum is
    identical serial or parallel.  Truncated units contribute their
    surviving-frontier lower bounds to the driver-level gap certificate.
    """
    best: Optional[MappingResult] = None
    frontier_lb = float("inf")
    for r in engine.run(units, inc_obj, tracer=tracer, budget=budget):
        stats.merge(r.stats)
        if r.truncated:
            frontier_lb = min(frontier_lb, r.lower_bound)
        c = r.candidate
        if c is not None and (
                best is None
                or c.objective(objective) < best.objective(objective)):
            best = c
    _certify_gap(stats, best, objective, inc_obj, frontier_lb)
    return best


def tcm_map_best_arch(
    einsum: Einsum,
    arches: Sequence[Arch],
    objective: str = "edp",
    prune_partial: bool = True,
    engine: Optional[SearchEngine] = None,
    backend: Optional[str] = None,
    workers: Optional[int] = None,
    share_incumbents: bool = True,
    inc_obj: float = float("inf"),
    tracer=None,
    budget=None,
    checkpoint=None,
) -> Tuple[int, Optional[MappingResult], MapperStats]:
    """Find the best (architecture, mapping) pair for ``einsum`` over a
    batch of candidate architectures in ONE engine dispatch.

    The work units of every architecture point are concatenated (with
    offset indices) and run through a single :class:`SearchEngine`, so the
    two-phase shared incumbent propagates *across* architecture points: a
    strong mapping found on one candidate prunes the others' subtrees.
    Sharing one incumbent is sound here because all units optimize the same
    einsum under the same objective — the returned winner's value equals
    ``min`` over per-arch :func:`tcm_map` runs — but per-point optima of the
    losing architectures are NOT recovered (their units may be cut by the
    global bound).  Use ``repro.dse.explore_space`` when per-point values or
    a Pareto frontier are needed.

    Returns ``(best_arch_index, result, merged_stats)``; the index is -1
    and the result None when no candidate admits a valid mapping.
    """
    tracer = active(tracer)
    stats = MapperStats()
    t0 = time.perf_counter()
    t_wall = time.time() if tracer is not None else 0.0
    units: List[WorkUnit] = []
    spans: List[int] = []  # spans[i] = first unit index of arch i
    with (tracer.span("enumerate", cat="phase", einsum=einsum.name,
                      n_arches=len(arches))
          if tracer is not None else nullcontext()):
        for arch in arches:
            spans.append(len(units))
            per = MapperStats()
            units += build_work_units(einsum, arch, objective, prune_partial,
                                      False, per, index_base=len(units))
            stats.merge(per)
    meter = ensure_meter(budget)
    owns_engine = engine is None
    if owns_engine:
        engine = make_engine(backend, workers,
                             share_incumbents=share_incumbents,
                             checkpoint=checkpoint)

    best: Optional[MappingResult] = None
    best_arch = -1
    frontier_lb = float("inf")
    try:
        for r in engine.run(units, inc_obj, tracer=tracer, budget=meter):
            stats.merge(r.stats)
            if r.truncated:
                frontier_lb = min(frontier_lb, r.lower_bound)
            c = r.candidate
            if c is not None and (
                    best is None
                    or c.objective(objective) < best.objective(objective)):
                best = c
                # unit indices are contiguous per arch, in arches order
                best_arch = sum(1 for s in spans[1:] if s <= r.index)
    finally:
        if owns_engine:
            engine.close()
    _certify_gap(stats, best, objective, inc_obj, frontier_lb)
    if best is not None:
        validate_structure(einsum, arches[best_arch], best.mapping)
    stats.finalize()
    stats.t_total = time.perf_counter() - t0
    if tracer is not None:
        extra = ({"truncated": True, "gap_bound": stats.gap_bound}
                 if stats.truncated else {})
        tracer.complete(
            f"tcm_map_best_arch:{einsum.name}", t_wall, cat="driver",
            backend=engine.backend, n_units=len(units),
            n_arches=len(arches), best_arch=best_arch,
            objective_kind=objective,
            objective=best.objective(objective) if best else None,
            n_expanded=stats.n_expanded, **extra)
    return best_arch, best, stats


def tcm_map_group(
    workload: FusedWorkload,
    arch: Arch,
    objective: str = "edp",
    prune_partial: bool = True,
    verbose: bool = False,
    engine: Optional[SearchEngine] = None,
    backend: Optional[str] = None,
    workers: Optional[int] = None,
    share_incumbents: bool = True,
    max_units: Optional[int] = 4096,
    inc_obj: float = float("inf"),
    tracer=None,
    budget=None,
    checkpoint=None,
) -> Tuple[Optional[MappingResult], MapperStats]:
    """Jointly map a fusion group: intermediates pinned on-chip, shared
    rank classes co-tiled, every (pin level, member dataplacement, member
    skeleton) combination dispatched as one fused work unit through the
    same search engines as ``tcm_map`` (incumbent sharing included).

    Returns ``(None, stats)`` when the group admits no pinned mapping (no
    legal pin level, a member cannot satisfy its pinned dataplacement, or
    the joint space exceeds ``max_units``) — callers fall back to
    independent per-einsum mapping.  The returned ``MappingResult`` carries
    a :class:`~repro.core.fusion.FusedMapping`; energy/latency are summed
    over the sequentially executed members, so its values compose with
    per-einsum results in network totals.

    ``inc_obj`` optionally seeds the branch-and-bound with the
    independent-mapping objective: fused candidates provably no better than
    the fallback are pruned.  When the fused optimum beats the bound, its
    value is found exactly (identical serial or parallel); otherwise the
    caller's fallback semantics apply regardless of what survives.
    """
    tracer = active(tracer)
    stats = MapperStats()
    t0 = time.perf_counter()
    t_wall = time.time() if tracer is not None else 0.0

    t = time.perf_counter()
    with (tracer.span("enumerate", cat="phase", group=workload.name)
          if tracer is not None else nullcontext()):
        skeletons = enumerate_fused_skeletons(workload, arch,
                                              max_units=max_units)
    stats.t_dataflow = time.perf_counter() - t
    stats.n_skeletons = len(skeletons)
    if not skeletons:
        stats.finalize()
        stats.t_total = time.perf_counter() - t0
        if tracer is not None:
            tracer.complete(f"tcm_map_group:{workload.name}", t_wall,
                            cat="driver", n_units=0, objective=None,
                            objective_kind=objective, n_expanded=0)
        return None, stats

    units = [WorkUnit(i, workload, arch, sk, objective, prune_partial)
             for i, sk in enumerate(skeletons)]
    meter = ensure_meter(budget)
    owns_engine = engine is None
    if owns_engine:
        engine = make_engine(backend, workers,
                             share_incumbents=share_incumbents,
                             checkpoint=checkpoint)
    if verbose:
        print(f"dispatching {len(units)} fused work units for "
              f"{workload.name} via {engine.backend}")

    best: Optional[MappingResult] = None
    try:
        best = _run_and_merge(units, objective, engine, stats,
                              inc_obj=inc_obj, tracer=tracer, budget=meter)
    finally:
        if owns_engine:
            engine.close()
    if best is not None:
        validate_fused(workload, arch, best.mapping)
    if verbose:
        print(f"merged {len(units)} fused units: "
              f"best={best.edp if best else None}")

    stats.finalize()
    stats.t_total = time.perf_counter() - t0
    if tracer is not None:
        extra = ({"truncated": True, "gap_bound": stats.gap_bound}
                 if stats.truncated else {})
        tracer.complete(
            f"tcm_map_group:{workload.name}", t_wall, cat="driver",
            backend=engine.backend, n_units=len(units),
            objective_kind=objective,
            objective=best.objective(objective) if best else None,
            n_expanded=stats.n_expanded, **extra)
    return best, stats
