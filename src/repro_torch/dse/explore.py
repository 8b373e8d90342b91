"""Architecture x mapping co-search over a parameterized design space.

``explore_space`` answers the question the paper's title promises: *which
accelerator* in a swept space minimizes EDP (or energy, or latency) for a
workload — reusing the fast mapper as the inner loop and mirroring its
bound-based pruning one level up:

  1. **Enumerate** the :class:`~repro_torch.core.arch.ArchSpace` (budget filters
     and arch-key dedup applied by ``materialize``).
  2. **Order** points by an optimistic roofline lower bound on the
     objective (``dse.roofline``), most promising first, so strong
     incumbents appear early.
  3. **Prune before search**: a point whose roofline floor is already
     dominated by an evaluated point — no better on the objective floor, no
     smaller in area, strictly worse in one — can enter neither the
     ``(objective, area)`` Pareto frontier nor the best-pair seat, and is
     skipped entirely.
  4. **Seed during search**: each surviving point's per-einsum searches are
     seeded through ``tcm_map(..., inc_obj=)`` with the best objective among
     evaluated points of no-larger area, minus the roofline floors of the
     point's other einsums (a sound residual bound, for EDP too: the
     workload's EDP dominates the sum of per-einsum EDPs).  A search cut by
     the seed proves the point is weakly dominated and it is dropped; a
     result below the seed is the exact per-einsum optimum, so evaluated
     points carry exact totals.
  5. **Warm cache**: per-(einsum, arch, objective) optima go through the
     persistent :class:`~repro_torch.netmap.cache.MappingCache` — sweep points
     revisited across runs (or shared between spaces) are served in
     milliseconds.  Only exact optima are cached; bound-cut searches never
     poison the store.

Soundness caveat: pruning is exact for the reported ``(objective, area)``
frontier and best pair, up to exact float ties across *distinct* arch
points (a tied point may be classified ``pruned_bound`` instead of
evaluated; identical architectures are already deduped by content key).

``explore_space_network`` sweeps whole-model workloads by running
``repro_torch.netmap.map_network`` per point (one shared engine + cache).  With
``fuse=True`` fused groups may beat the per-einsum roofline floors (a
pinned intermediate never touches DRAM), so dominance pruning is disabled
and the roofline is used for ordering only.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.arch import ArchPoint, ArchSpace
from repro_torch.core.budget import ensure_meter
from repro_torch.core.einsum import Einsum
from repro_torch.core.looptree import render
from repro_torch.core.mapper import tcm_map
from repro_torch.core.search import MapperStats, SearchEngine, make_engine
from repro_torch.obs.tracer import active

from .report import (DSEReport, EVALUATED, INFEASIBLE, PRUNED_BOUND,
                     PRUNED_ROOFLINE, SKIPPED_BUDGET, PointRow)
from .roofline import RooflineBound, einsum_bounds, workload_bounds


def _combine(energy: float, latency: float, objective: str) -> float:
    return RooflineBound(energy, latency).objective(objective)


class _Cut(Exception):
    """A point's search was cut by the seeded incumbent bound."""


class _Infeasible(Exception):
    """A point was *proven* to admit no valid mapping: its search came up
    empty under an infinite bound, so nothing was cut.  Under a finite
    seed threshold an empty search only proves "no better than the
    incumbent" — such points are classified ``pruned_bound`` even if they
    happen to be infeasible (see ``report.py`` status semantics)."""


def _dominated_by_evaluated(row: PointRow, evaluated: Sequence[PointRow]
                            ) -> bool:
    for q in evaluated:
        if (q.area_mm2 <= row.area_mm2 and q.objective <= row.obj_lb
                and (q.area_mm2 < row.area_mm2 or q.objective < row.obj_lb)):
            return True
    return False


def _seed_threshold(row: PointRow, evaluated: Sequence[PointRow]) -> float:
    return min((q.objective for q in evaluated
                if q.area_mm2 <= row.area_mm2), default=float("inf"))


def explore_space(
    space: ArchSpace,
    einsums: Sequence[Einsum],
    objective: str = "edp",
    prune_partial: bool = True,
    cache=None,
    engine: Optional[SearchEngine] = None,
    backend: Optional[str] = None,
    workers: Optional[int] = None,
    share_incumbents: bool = True,
    roofline_order: bool = True,
    prune: bool = True,
    seed_incumbents: bool = True,
    max_points: Optional[int] = None,
    collect_mappings: bool = True,
    verbose: bool = False,
    tracer=None,
    budget=None,
    checkpoint=None,
) -> DSEReport:
    """Co-search architectures and mappings for a list of einsums.

    ``prune=False, seed_incumbents=False`` is the exhaustive oracle: every
    point is evaluated exactly by per-einsum ``tcm_map`` — same frontier,
    strictly more expanded nodes.  All backends are value-identical (the
    per-point optima inherit the engines' parity contract; only the
    ``n_expanded`` counters depend on worker scheduling).

    ``budget`` spans the whole sweep: one meter is shared by every point's
    searches; on expiry in-flight searches return their incumbents
    (``row.truncated`` + certified ``row.gap_bound``) and unreached points
    are marked ``skipped_budget``.  ``checkpoint`` journals finished work
    units so an interrupted sweep resumes mid-search; a ``KeyboardInterrupt``
    returns the partial report (``interrupted=True``) instead of raising —
    re-running with the same cache/checkpoint completes the remaining
    points and reaches the same frontier as an uninterrupted sweep.
    """
    einsums = list(einsums)
    meter = ensure_meter(budget)
    workload = "+".join(e.name for e in einsums)
    lb_cache: dict = {}  # point key -> per-einsum bounds, computed once

    def lbs_of(point: ArchPoint) -> List[RooflineBound]:
        if point.key not in lb_cache:
            lb_cache[point.key] = [einsum_bounds(e, point.arch)
                                   for e in einsums]
        return lb_cache[point.key]

    def point_bounds(point: ArchPoint) -> RooflineBound:
        bs = lbs_of(point)
        return RooflineBound(energy=sum(b.energy for b in bs),
                             latency=sum(b.latency for b in bs))

    def evaluate(point: ArchPoint, row: PointRow, threshold: float,
                 engine: SearchEngine) -> None:
        per_lb = [b.objective(objective) for b in lbs_of(point)]
        parts: List[Optional[float]] = [None] * len(einsums)
        energy = latency = 0.0
        for i, e in enumerate(einsums):
            hit = (cache.get(e, point.arch, objective, prune_partial)
                   if cache is not None else None)
            if hit is not None:
                result = hit.result
                row.cached += 1
            else:
                rest = sum(parts[j] if parts[j] is not None else per_lb[j]
                           for j in range(len(einsums)) if j != i)
                t_i = threshold - rest
                if t_i <= 0:
                    raise _Cut
                t0 = time.perf_counter()
                result, stats = tcm_map(
                    e, point.arch, objective=objective,
                    prune_partial=prune_partial, collect_sizes=False,
                    engine=engine, inc_obj=t_i, tracer=tracer,
                    budget=meter)
                dt = time.perf_counter() - t0
                row.t_search += dt
                row.n_expanded += stats.n_expanded
                if row.stats is None:
                    row.stats = MapperStats()
                row.stats.merge(stats)
                if stats.truncated:
                    row.truncated = True
                    row.gap_bound = max(row.gap_bound, stats.gap_bound)
                if result is None and t_i == float("inf"):
                    if stats.truncated:
                        raise _Cut  # budget, not infeasibility, emptied it
                    raise _Infeasible  # nothing cut this: no valid mapping
                if result is None or result.objective(objective) >= t_i:
                    raise _Cut  # provably no better than the incumbent point
                # truncated results are anytime incumbents, never cached
                if cache is not None and not stats.truncated:
                    cache.put(e, point.arch, objective, result, stats, dt,
                              prune_partial)
            parts[i] = result.objective(objective)
            energy += result.energy
            latency += result.latency
            if collect_mappings:
                row.mappings[e.name] = render(result.mapping)
        row.energy = energy
        row.latency = latency
        row.objective = _combine(energy, latency, objective)
        if row.stats is not None:
            row.stats.finalize()

    return _sweep(space, workload, objective, evaluate, point_bounds,
                  cache=cache, engine=engine, backend=backend,
                  workers=workers, share_incumbents=share_incumbents,
                  roofline_order=roofline_order, prune=prune,
                  seed_incumbents=seed_incumbents, max_points=max_points,
                  verbose=verbose, tracer=tracer, budget=meter,
                  checkpoint=checkpoint)


def explore_space_network(
    space: ArchSpace,
    cfg,
    objective: str = "edp",
    mode: str = "decode",
    batch: int = 1,
    seq: int = 1024,
    fuse: bool = False,
    cache=None,
    engine: Optional[SearchEngine] = None,
    backend: Optional[str] = None,
    workers: Optional[int] = None,
    share_incumbents: bool = True,
    roofline_order: bool = True,
    prune: bool = True,
    max_points: Optional[int] = None,
    verbose: bool = False,
    tracer=None,
    budget=None,
    checkpoint=None,
) -> DSEReport:
    """Sweep a space against a whole model config via ``netmap``.

    Each point runs :func:`repro_torch.netmap.planner.map_network` (one shared
    engine and mapping cache across the sweep); the row totals are the
    network totals.  ``fuse=True`` forces ``prune=False`` — fused mappings
    can beat the per-einsum roofline floors, so the floors only order the
    sweep.
    """
    from repro_torch.netmap.extract import extract_einsums
    from repro_torch.netmap.planner import NoValidMappingError, map_network

    if fuse:
        prune = False  # roofline floors assume unfused per-einsum mapping
    entries = extract_einsums(cfg, mode=mode, batch=batch, seq=seq)
    lb_entries = [(en.einsum, en.count) for en in entries]
    workload = f"{cfg.name}[{mode},b={batch},s={seq}]"
    meter = ensure_meter(budget)

    def evaluate(point: ArchPoint, row: PointRow, threshold: float,
                 engine: SearchEngine) -> None:
        try:
            rep = map_network(cfg, point.arch, objective=objective,
                              mode=mode, batch=batch, seq=seq, cache=cache,
                              engine=engine, fuse=fuse, verbose=False,
                              tracer=tracer, budget=meter)
        except NoValidMappingError:
            # exactly the planner's infeasibility signal — engine/pool
            # RuntimeErrors (e.g. BrokenProcessPool) propagate and abort
            raise _Infeasible
        if rep.interrupted:
            # the planner caught SIGINT and returned a partial report —
            # that is not a point evaluation; stop the sweep instead
            raise KeyboardInterrupt
        row.t_search += rep.t_search
        # NetworkReport.n_evaluated sums the backing searches' n_expanded
        # (cache hits replay the cold search's count — see planner.py)
        row.n_expanded += rep.n_evaluated
        row.cached += rep.cache_hits
        row.energy = rep.total_energy
        row.latency = rep.total_latency
        row.objective = _combine(rep.total_energy, rep.total_latency,
                                 objective)
        if rep.truncated:
            row.truncated = True
            row.gap_bound = max(row.gap_bound, rep.gap_bound)

    return _sweep(space, workload, objective, evaluate,
                  lambda p: workload_bounds(lb_entries, p.arch),
                  cache=cache, engine=engine, backend=backend,
                  workers=workers, share_incumbents=share_incumbents,
                  roofline_order=roofline_order, prune=prune,
                  seed_incumbents=False,  # map_network has no seeding hook
                  max_points=max_points, verbose=verbose, tracer=tracer,
                  budget=meter, checkpoint=checkpoint)


def _sweep(space, workload, objective, evaluate, point_bounds, *, cache,
           engine, backend, workers, share_incumbents, roofline_order,
           prune, seed_incumbents, max_points, verbose,
           tracer=None, budget=None, checkpoint=None) -> DSEReport:
    tracer = active(tracer)
    meter = ensure_meter(budget)
    t0 = time.perf_counter()
    t_wall0 = time.time() if tracer is not None else 0.0
    points, counters = space.materialize(max_points=max_points)
    report = DSEReport(space=space.name, workload=workload,
                       objective=objective, **counters)

    rows: List[Tuple[ArchPoint, PointRow]] = []
    for p in points:
        b = point_bounds(p)
        rows.append((p, PointRow(
            name=p.arch.name, coords=p.coords_str, arch_key=p.key,
            area_mm2=p.area_mm2, pe=p.arch.total_compute_units,
            energy_lb=b.energy, latency_lb=b.latency,
            obj_lb=b.objective(objective))))
    if roofline_order:
        rows.sort(key=lambda pr: (pr[1].obj_lb, pr[1].area_mm2, pr[1].name))

    hits0 = cache.hits if cache is not None else 0
    misses0 = cache.misses if cache is not None else 0
    owns_engine = engine is None
    if owns_engine:
        engine = make_engine(backend, workers,
                             share_incumbents=share_incumbents,
                             checkpoint=checkpoint)

    evaluated: List[PointRow] = []
    try:
        for point, row in rows:
            report.rows.append(row)
            if meter is not None and meter.expired():
                row.status = SKIPPED_BUDGET
                report.n_skipped_budget += 1
                report.truncated = True
                if tracer is not None:
                    tracer.instant("skipped_budget", cat="budget",
                                   point=row.coords or row.name)
                continue
            if prune and _dominated_by_evaluated(row, evaluated):
                row.status = PRUNED_ROOFLINE
                report.n_pruned_roofline += 1
                if tracer is not None:
                    tracer.instant("pruned_roofline", cat="dse",
                                   point=row.coords or row.name,
                                   obj_lb=row.obj_lb,
                                   area_mm2=row.area_mm2)
                if verbose:
                    print(f"  {row.coords:<44} pruned (roofline floor "
                          f">{row.obj_lb:.3g} dominated)")
                continue
            threshold = (_seed_threshold(row, evaluated)
                         if seed_incumbents else float("inf"))
            t_point = time.time() if tracer is not None else 0.0
            try:
                evaluate(point, row, threshold, engine)
            except (_Cut, _Infeasible) as stop:
                if isinstance(stop, _Infeasible):
                    row.status = INFEASIBLE
                    report.n_infeasible += 1
                else:
                    row.status = PRUNED_BOUND
                    report.n_pruned_bound += 1
                # search time spent before the stop still counts; mappings
                # rendered for einsums finished before it do not (the
                # PointRow contract: mappings on evaluated points only)
                report.t_search += row.t_search
                row.mappings.clear()
                if tracer is not None:
                    tracer.instant(row.status, cat="dse",
                                   point=row.coords or row.name,
                                   threshold=threshold)
                    tracer.complete(f"point:{row.coords or row.name}",
                                    t_point, cat="dse", status=row.status,
                                    n_expanded=row.n_expanded)
                if verbose:
                    what = ("no valid mapping"
                            if isinstance(stop, _Infeasible) else
                            f"seeded bound {threshold:.4g} cut the search")
                    print(f"  {row.coords:<44} pruned ({what})")
                continue
            row.status = EVALUATED
            evaluated.append(row)
            report.n_evaluated += 1
            report.t_search += row.t_search
            if row.truncated:
                report.truncated = True
                report.gap_bound = max(report.gap_bound, row.gap_bound)
            if tracer is not None:
                tracer.instant("evaluated", cat="dse",
                               point=row.coords or row.name,
                               objective=row.objective,
                               area_mm2=row.area_mm2, cached=row.cached)
                tracer.complete(f"point:{row.coords or row.name}", t_point,
                                cat="dse", status=row.status,
                                objective=row.objective,
                                n_expanded=row.n_expanded)
            if verbose:
                print(f"  {row.coords:<44} {objective}="
                      f"{row.objective:.4g} area={row.area_mm2:.2f}mm2 "
                      f"({row.cached} cached, {row.t_search:.2f}s)")
    except KeyboardInterrupt:
        # partial sweep: finalize what finished; a re-run with the same
        # cache/checkpoint completes the remaining points
        report.interrupted = True
        if tracer is not None:
            tracer.instant("interrupted", cat="fault", space=space.name,
                           n_evaluated=report.n_evaluated)
    finally:
        if owns_engine:
            engine.close()

    report.n_expanded = sum(r.n_expanded for r in report.rows)
    if cache is not None:
        report.cache_hits = cache.hits - hits0
        report.cache_misses = cache.misses - misses0
    report.finalize_frontier()
    report.t_total = time.perf_counter() - t0
    if tracer is not None:
        extra = {}
        if report.truncated:
            extra.update(truncated=True, gap_bound=report.gap_bound,
                         n_skipped_budget=report.n_skipped_budget)
        if report.interrupted:
            extra.update(interrupted=True)
        tracer.complete(
            f"explore_space:{space.name}", t_wall0, cat="driver",
            backend=engine.backend, workload=workload,
            n_points=report.n_points, n_evaluated=report.n_evaluated,
            n_pruned_roofline=report.n_pruned_roofline,
            n_pruned_bound=report.n_pruned_bound,
            n_expanded=report.n_expanded,
            best=report.best.name if report.best else None, **extra)
    return report


def check_parity(space: ArchSpace, einsums: Sequence[Einsum],
                 objective: str = "edp", n_points: Optional[int] = None,
                 workers: Optional[int] = None) -> Tuple[bool, str]:
    """Oracle check: pruned+seeded explorer vs exhaustive per-point search.

    Runs both on the (optionally truncated) space and compares the Pareto
    frontier, per-frontier-point totals and the best pair.  Returns
    ``(ok, message)``; the message summarizes the node-count saving.
    """
    fast = explore_space(space, einsums, objective, workers=workers,
                         max_points=n_points, collect_mappings=False)
    slow = explore_space(space, einsums, objective, workers=workers,
                         max_points=n_points, prune=False,
                         seed_incumbents=False, collect_mappings=False)

    def front(rep):
        return sorted((r.arch_key, r.objective, r.energy, r.latency,
                       r.area_mm2) for r in rep.frontier)

    if front(fast) != front(slow):
        return False, (f"frontier mismatch: {front(fast)} != {front(slow)}")
    fb, sb = fast.best, slow.best
    if (fb is None) != (sb is None) or (
            fb is not None and (fb.arch_key != sb.arch_key
                                or fb.objective != sb.objective)):
        return False, "best-pair mismatch"
    return True, (
        f"parity ok ({fast.n_points} points, frontier="
        f"{len(fast.frontier)}): explorer expanded {fast.n_expanded} "
        f"nodes vs {slow.n_expanded} exhaustive "
        f"({fast.n_pruned_roofline}+{fast.n_pruned_bound} points pruned)")
